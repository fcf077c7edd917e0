"""Fault injection for the policy path (chaos testing the benchmark harness).

The port's copy of ``sage3d_tpu/serve/chaos.py``.

The reference has extensive failure HANDLING (smart fallbacks, retries,
episode isolation — SURVEY.md 5.3) but no way to INJECT failures and prove the
handling works. These wrappers make the failure paths testable:

  * FlakyPolicy: raises / times out / returns garbage on a seeded schedule;
  * SlowPolicy: adds latency (exercise timeout handling);
  * both compose around any policy callable used by bench/runner.py.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Dict


class PolicyFault(RuntimeError):
    pass


class FlakyPolicy:
    """Wraps a policy; injects failures with probability ``fault_rate``.

    fault kinds cycle among: raise, error-dict (the client's failure shape),
    and malformed output (missing keys).
    """

    def __init__(self, inner: Callable, fault_rate: float = 0.3, seed: int = 0):
        self.inner = inner
        self.fault_rate = fault_rate
        self.rng = random.Random(seed)
        self.faults_injected = 0
        self.calls = 0

    def __call__(self, images=None, instruction: str = "", current_yaw=0.0,
                 depth_images=None, **kw) -> Dict[str, Any]:
        self.calls += 1
        if self.rng.random() < self.fault_rate:
            self.faults_injected += 1
            kind = self.rng.choice(["raise", "error_dict", "malformed"])
            if kind == "raise":
                raise PolicyFault("injected policy failure")
            if kind == "error_dict":
                return {"vx": 0.0, "vy": 0.0, "yaw_rate": 0.0,
                        "duration_s": 1.0, "stop": True,
                        "raw_response": "Error: injected",
                        "parsed_from": "error"}
            return {"nonsense": True}
        return self.inner(images=images, instruction=instruction,
                          current_yaw=current_yaw, depth_images=depth_images,
                          **kw)


class SlowPolicy:
    def __init__(self, inner: Callable, delay_s: float = 0.2):
        self.inner = inner
        self.delay_s = delay_s

    def __call__(self, **kw):
        time.sleep(self.delay_s)
        return self.inner(**kw)
