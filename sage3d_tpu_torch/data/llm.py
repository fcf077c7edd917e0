"""LLM client layer: OpenAI-compatible chat API + deterministic mock.

The reference talks to an OpenAI-compatible endpoint with retries and thread
pools (vln_trajectory_generator.py:90-135 OpenAIClient, scene_text_generator.py:
59-98). Here the client is one small class behind an interface, and every
LLM-dependent pipeline stage accepts any client — in particular ``MockLLMClient``,
a deterministic template-based stand-in that makes the whole data pipeline
runnable and testable offline (the fake backend the reference lacks).

Retry behavior mirrors the reference: up to 5 attempts with exponential backoff
capped at 16 s (vln_trajectory_generator.py:1607-1643).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional

MAX_RETRIES = 5
BACKOFF_CAP_S = 16.0


class LLMClient(ABC):
    @abstractmethod
    def chat(self, messages: List[Dict[str, str]], temperature: float = 0.7,
             max_tokens: int = 2048) -> str: ...

    def chat_with_retry(self, messages, **kw) -> Optional[str]:
        for attempt in range(MAX_RETRIES):
            try:
                return self.chat(messages, **kw)
            except Exception:
                if attempt == MAX_RETRIES - 1:
                    return None
                time.sleep(min(2.0 ** attempt, BACKOFF_CAP_S))
        return None


class OpenAIClient(LLMClient):
    """OpenAI-compatible chat-completions client (requests-based, no SDK)."""

    def __init__(self, api_key: Optional[str] = None,
                 base_url: Optional[str] = None, model: Optional[str] = None,
                 timeout: float = 60.0):
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = (base_url or os.environ.get(
            "OPENAI_BASE_URL", "https://api.openai.com/v1")).rstrip("/")
        self.model = model or os.environ.get("OPENAI_MODEL", "gpt-4o-mini")
        self.timeout = timeout

    def chat(self, messages, temperature: float = 0.7,
             max_tokens: int = 2048) -> str:
        import requests
        resp = requests.post(
            f"{self.base_url}/chat/completions",
            headers={"Authorization": f"Bearer {self.api_key}",
                     "Content-Type": "application/json"},
            json={"model": self.model, "messages": messages,
                  "temperature": temperature, "max_tokens": max_tokens},
            timeout=self.timeout)
        resp.raise_for_status()
        return resp.json()["choices"][0]["message"]["content"]


class MockLLMClient(LLMClient):
    """Deterministic offline LLM: template answers keyed on the request.

    Understands the three request kinds the pipeline issues:
      * pair judging ("meaningful" yes/no batches) -> accepts every pair;
      * instruction generation -> templated instruction per type;
      * scene text generation -> a terse object list summary.
    """

    INSTRUCTION_TEMPLATES = {
        "AC": "Go from the {start} to the {end}.",
        "SD": "Starting at the {start}, walk across the room and stop at the {end}.",
        "RR": "Leave the {start} behind and make your way over to the {end}.",
        "Att": "Find the {end}; begin near the {start}.",
        "Ar": "Head toward the area around the {end}, starting from the {start}.",
        "Goal-less": "Explore this environment as much as possible, but avoid "
                     "colliding with objects, walls, etc., and maintain safe "
                     "navigation.",
        "NR": "Navigate from the {start} to the {end} without touching anything.",
    }

    def __init__(self, accept_all_pairs: bool = True):
        self.accept_all_pairs = accept_all_pairs
        self.calls: List[Dict[str, Any]] = []

    TYPE_PHRASES = {
        "Add_Object": "Carry the book from the {start} over to the {end}.",
        "Scenario_Driven": "I left my keys by the {end}; please go there "
                           "from the {start}.",
        "Relative_Relationship": "Head to the {end} that sits across from "
                                 "the {start}.",
        "Attribute-based": "Find the large {end}, starting out at the {start}.",
        "Area-based": "Go from the {start} to the area around the {end}.",
    }

    def chat(self, messages, temperature: float = 0.7,
             max_tokens: int = 2048) -> str:
        content = messages[-1]["content"] if messages else ""
        full = "\n".join(m.get("content", "") for m in messages)
        self.calls.append({"content": content})

        # pairwise judgement (template contract: JSON array with pair_id)
        if "pair_id" in full and "meaningful" in full.lower():
            entries = re.findall(r'"pair_id"\s*:\s*(\d+)\s*,\s*"start"\s*:\s*'
                                 r'"([^"]*)"\s*,\s*"end"\s*:\s*"([^"]*)"',
                                 content)
            if entries:
                return json.dumps([
                    {"pair_id": int(i), "start": s, "end": e,
                     "meaningful": bool(self.accept_all_pairs)}
                    for i, s, e in entries])
            pairs = re.findall(r"\d+\s*[.:]", content)
            verdict = "yes" if self.accept_all_pairs else "no"
            return json.dumps({str(i + 1): verdict
                               for i in range(max(len(pairs), 1))})

        # trajectory -> instructions (template contract: typed JSON array)
        if "starting_point" in content or "instruction" in full.lower():
            m_start = re.search(r'"starting_point"\s*:\s*"([^"]+)"', content)
            m_end = re.search(r'"end_point"\s*:\s*"([^"]+)"', content)
            start = m_start.group(1) if m_start else "starting point"
            end = m_end.group(1) if m_end else "destination"
            records = []
            for itype, phrase in self.TYPE_PHRASES.items():
                for k in range(2):   # template asks for 2-4 per type
                    text = phrase.format(start=start, end=end)
                    if k:
                        text = text.replace("Go ", "Walk ").replace(
                            "Head ", "Make your way ").replace(
                            "Find ", "Locate ").replace("Carry ", "Bring ")
                    records.append({"instruction_type": itype, "start": start,
                                    "end": end,
                                    "generated_instruction": text})
            return json.dumps(records)

        # scene-text generation: summarize label keys deterministically
        keys = re.findall(r"label_\w+", content)
        digest = hashlib.md5(content.encode()).hexdigest()[:8]
        return (f"The scene contains {len(set(keys))} labeled objects "
                f"({', '.join(sorted(set(keys))[:8])}). [mock {digest}]")


def robust_json_parse(text: str) -> Optional[Any]:
    """Extract the first JSON object/array from free-form LLM text
    (vln_trajectory_generator.py:210-233)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    for pattern in (r"\{.*\}", r"\[.*\]"):
        m = re.search(pattern, text, re.DOTALL)
        if m:
            try:
                return json.loads(m.group(0))
            except json.JSONDecodeError:
                continue
    return None
