"""The port's serving path against the JAX package's: the MLLM adapters and
wire server, the stateful adapter, fault injection, the CNN policy and the
micro-batching server.

The adapter tests use the same fakes as tests/test_mllm_adapters.py (no
weights, no transformers). The CNN is held to the JAX module's
``cnn_policy_apply`` on parameters carried across by ``cnn_params_from_jax``,
within 1e-5 of the largest logit, at even sizes and at an odd one (where
XLA's ``SAME`` padding is one pixel before and one after).
"""

import socket
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sage3d_tpu.serve import jax_policy as jp
from sage3d_tpu_torch.serve import torch_policy as tp
from sage3d_tpu_torch.serve.mllm_server import (CallableAdapter,
                                                InternVLAdapter, LLaVAAdapter,
                                                MLLMServer, MODEL_ADAPTERS,
                                                QwenVLAdapter,
                                                VideoPromptAdapter,
                                                VLNPromptTemplate,
                                                extract_action,
                                                make_hf_adapter)
from sage3d_tpu_torch.serve.protocol import (encode_image_b64, recv_framed,
                                             send_framed, socket_request)

CNN_REL = 1e-5      # port vs JAX logits, over max |logit|


def _image(w=64, h=48, value=128):
    return Image.fromarray(np.full((h, w, 3), value, np.uint8))


# -- the HF adapters, with the JAX tests' fakes --------------------------------

class _FakeTensorDict(dict):
    def to(self, device):
        return self


class _FakeQwenProcessor:
    def __init__(self):
        self.calls = {}

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=False):
        self.calls["messages"] = messages
        assert not tokenize and add_generation_prompt
        parts = []
        for m in messages:
            c = m["content"]
            if isinstance(c, str):
                parts.append(f"<|{m['role']}|>{c}")
            else:
                for item in c:
                    parts.append("<img>" if item["type"] == "image"
                                 else item["text"])
        return "".join(parts) + "<|assistant|>"

    def __call__(self, text, images=None, return_tensors=None, padding=False):
        self.calls["text"] = text
        self.calls["images"] = images
        return _FakeTensorDict(input_ids=[[1, 2, 3, 4]])

    def batch_decode(self, seqs, skip_special_tokens=True):
        return ["decoded:" + ",".join(str(x) for x in s) for s in seqs]


class _FakeQwenModel:
    device = None

    def generate(self, input_ids, max_new_tokens):
        return [list(i) + [7, 8] for i in input_ids]


class _FakeLLaVAProcessor:
    def __init__(self):
        self.prompt = None

    def __call__(self, text, images=None, return_tensors=None):
        self.prompt = text
        return _FakeTensorDict(input_ids=np.zeros((1, 5), np.int64))

    def decode(self, seq, skip_special_tokens=True):
        return "decoded:" + ",".join(str(int(x)) for x in seq)


class _FakeLLaVAModel:
    device = None

    def generate(self, input_ids, max_new_tokens):
        return np.concatenate([input_ids, np.full((1, 2), 9)], axis=1)


class _FakeInternVLModel:
    device = None

    def __init__(self):
        self.seen = {}

    def chat(self, tokenizer, pixel_values, prompt, config):
        self.seen = {"pixel_values": pixel_values, "prompt": prompt,
                     "config": config}
        return "TURN_RIGHT"


class _FakeTokenizer:
    eos_token_id = 2


def test_qwen_adapter_chat_template_and_trim():
    proc = _FakeQwenProcessor()
    a = QwenVLAdapter(model=_FakeQwenModel(), processor=proc)
    out = a.generate_response([_image()], "go to the sofa")
    msgs = proc.calls["messages"]
    assert msgs[0] == {"role": "system", "content": VLNPromptTemplate.SYSTEM}
    assert msgs[1]["content"][0]["type"] == "image"
    assert "go to the sofa" in msgs[1]["content"][1]["text"]
    assert isinstance(proc.calls["text"], list)
    assert isinstance(proc.calls["images"], list)
    assert out == "decoded:7,8"


def test_llava_adapter_conversation_string():
    proc = _FakeLLaVAProcessor()
    a = LLaVAAdapter(model=_FakeLLaVAModel(), processor=proc)
    out = a.generate_response([_image()], "turn left at the door")
    assert proc.prompt.startswith("USER: <image>\n")
    assert proc.prompt.endswith("ASSISTANT:")
    assert VLNPromptTemplate.SYSTEM in proc.prompt
    assert "turn left at the door" in proc.prompt
    assert out == "decoded:9,9"


def test_internvl_adapter_chat_and_preprocess():
    m = _FakeInternVLModel()
    a = InternVLAdapter(model=m, tokenizer=_FakeTokenizer())
    out = a.generate_response([_image(200, 100, value=255)], "find the lamp")
    assert out == "TURN_RIGHT"
    pv = m.seen["pixel_values"]
    assert tuple(pv.shape) == (1, 3, 448, 448)
    got = pv[0, :, 0, 0].numpy()
    want = (1.0 - np.array(a.MEAN)) / np.array(a.STD)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert "find the lamp" in m.seen["prompt"]
    assert m.seen["config"]["pad_token_id"] == 2


def test_family_dispatch():
    assert MODEL_ADAPTERS["qwen"] is QwenVLAdapter
    assert MODEL_ADAPTERS["llava"] is LLaVAAdapter
    assert MODEL_ADAPTERS["internvl"] is InternVLAdapter
    a = make_hf_adapter("Qwen/Qwen2.5-VL-7B-Instruct",
                        model=_FakeQwenModel(),
                        processor=_FakeQwenProcessor())
    assert isinstance(a, QwenVLAdapter)
    b = make_hf_adapter("llava-hf/llava-1.5-7b-hf",
                        model=_FakeLLaVAModel(),
                        processor=_FakeLLaVAProcessor())
    assert isinstance(b, LLaVAAdapter)
    c = make_hf_adapter("OpenGVLab/InternVL2_5-8B",
                        model=_FakeInternVLModel(),
                        tokenizer=_FakeTokenizer())
    assert isinstance(c, InternVLAdapter)


def test_qwen_llava_text_only_requests():
    proc = _FakeQwenProcessor()
    a = QwenVLAdapter(model=_FakeQwenModel(), processor=proc)
    assert a.generate_response([], "stop at the table") == "decoded:7,8"
    msgs = proc.calls["messages"]
    assert all(item["type"] == "text" for item in msgs[1]["content"])
    assert proc.calls["images"] is None

    lproc = _FakeLLaVAProcessor()
    b = LLaVAAdapter(model=_FakeLLaVAModel(), processor=lproc)
    assert b.generate_response([], "stop at the table") == "decoded:9,9"
    assert "<image>" not in lproc.prompt
    assert lproc.prompt.startswith("USER: ")


def test_server_sends_framed_error_reply():
    class _Boom:
        def generate_response(self, images, instruction):
            raise RuntimeError("model exploded")

        def extract_action(self, raw):
            return raw

    srv = MLLMServer(_Boom(), port=0).start()
    try:
        with socket.create_connection(("localhost", srv.port), timeout=10) as c:
            send_framed(c, {"query": "go", "images": []})
            reply = recv_framed(c)
        assert reply["result"] == "STOP"
        assert "model exploded" in reply["error"]
    finally:
        srv.stop()


def test_hf_adapters_default_to_the_card():
    """The port's HF adapters take device=None, meaning the card; the
    device is resolved before any model loads, so without a card the
    constructor raises (the JAX package's default is the CPU)."""
    import inspect

    from sage3d_tpu_torch.serve import mllm_server
    for cls in (mllm_server.HFAdapter, mllm_server.HFVideoAdapter,
                QwenVLAdapter, LLaVAAdapter, InternVLAdapter):
        assert inspect.signature(cls).parameters["device"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mllm_server._device(None)
    assert mllm_server._device("cpu") == "cpu"


# -- action extraction and the wire round trip (test_aux_subsystems) ----------

def test_mllm_server_action_extraction():
    from sage3d_tpu.serve.mllm_server import extract_action as jextract
    texts = ["I should TURN_LEFT now", "move ahead slowly", "we are done here",
             "turn to the right side", "???"]
    want = ["TURN_LEFT", "MOVE_FORWARD", "STOP", "TURN_RIGHT", "MOVE_FORWARD"]
    assert [extract_action(t) for t in texts] == want
    assert [jextract(t) for t in texts] == want


def test_mllm_server_roundtrip():
    def fake_model(images, instruction):
        assert len(images) == 1
        return f"Given '{instruction[:10]}' I will TURN_LEFT."

    with MLLMServer(CallableAdapter(fake_model), port=0) as srv:
        img = encode_image_b64(np.zeros((8, 8, 3), np.uint8))
        resp = socket_request("127.0.0.1", srv.port,
                              {"images": [img], "query": "go to the door"})
        assert resp["result"] == "TURN_LEFT"
        resp2 = socket_request("127.0.0.1", srv.port, {"action": "reset"})
        assert resp2["result"] == "reset_ok"
        assert srv.stats["requests"] == 1


# -- stateful adapter and chaos (test_serve_extras) --------------------------

def test_parse_motion_text_and_velocity_match_jax():
    from sage3d_tpu.serve import stateful_adapter as js
    from sage3d_tpu_torch.serve import stateful_adapter as ts
    assert ts.parse_motion_text("move forward 75 cm") == ["MOVE_FORWARD"] * 3
    assert ts.parse_motion_text("turn left 60 degree") == ["TURN_LEFT"] * 2
    assert ts.parse_motion_text("we are done") == ["STOP"]
    assert ts.parse_motion_text("???") == ["MOVE_FORWARD"]
    assert len(ts.parse_motion_text("move forward 500 cm")) == 3
    for text in ("move forward 25 cm", "forward 1.5 m", "turn right 30 degree",
                 "go left", "right", "finish", "walk"):
        assert ts.parse_motion_text(text) == js.parse_motion_text(text)
    for a in ("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT", "STOP"):
        assert ts.action_to_velocity(a) == js.action_to_velocity(a)
    assert ts.action_to_velocity("MOVE_FORWARD")["vx"] == 0.25
    assert ts.action_to_velocity("TURN_LEFT")["yaw_rate"] > 0


def test_stateful_adapter_queue_and_reset():
    from sage3d_tpu_torch.serve.stateful_adapter import StatefulVLNAdapter
    calls = []

    def model(frames, instruction):
        calls.append(len(frames))
        return "move forward 75 cm"

    ad = StatefulVLNAdapter(model)
    assert ad.generate_response(["f1"], "go") == "MOVE_FORWARD"
    assert ad.generate_response(["f2"], "go") == "MOVE_FORWARD"
    assert ad.generate_response(["f3"], "go") == "MOVE_FORWARD"
    assert len(calls) == 1
    ad.generate_response(["f4"], "go")
    assert calls[-1] == 4
    ad.reset()
    assert ad.frame_history == [] and ad.pending == []


def test_flaky_policy_runner_resilience(tmp_path):
    """The port's runner survives a 60%-faulty policy and still finishes."""
    from sage3d_tpu_torch.bench.episodes import adapt_gvln_to_episodes
    from sage3d_tpu_torch.bench.runner import run_episode
    from sage3d_tpu_torch.env.vln_env import GaussianVLNEnv
    from sage3d_tpu_torch.renderer.scene import synthetic_room
    from sage3d_tpu_torch.serve.chaos import FlakyPolicy
    from tests.test_bench_harness import make_gvln_json

    traj, mp = make_gvln_json(tmp_path)
    env = GaussianVLNEnv(synthetic_room(120, seed=3, device="cpu"),
                         map_json=str(mp), width=48, height=48, device="cpu")
    ep = adapt_gvln_to_episodes(traj, "x.ply")[0]

    def base(images, instruction, current_yaw=0.0, depth_images=None, **kw):
        return {"vx": 0.3, "vy": 0.0, "yaw_rate": 0.0, "duration_s": 1.0,
                "stop": False}

    flaky = FlakyPolicy(base, fault_rate=0.6, seed=7)
    rec = run_episode(env, ep, flaky, max_steps=8)
    assert rec["episode_info"]["steps_run"] >= 1
    assert flaky.faults_injected > 0
    assert "measurements" in rec


def test_chaos_fault_schedule_matches_jax():
    """The same seed injects the same faults, call for call."""
    from sage3d_tpu.serve.chaos import FlakyPolicy as JFlaky
    from sage3d_tpu_torch.serve.chaos import (FlakyPolicy, PolicyFault,
                                              SlowPolicy)

    def base(**kw):
        return {"stop": False}

    def outcomes(policy):
        out = []
        for _ in range(40):
            try:
                out.append(sorted(policy(images=[], instruction="x")))
            except RuntimeError as e:
                out.append(type(e).__name__)
        return out

    got = outcomes(FlakyPolicy(base, 0.5, seed=3))
    assert got == outcomes(JFlaky(base, 0.5, seed=3))
    assert "PolicyFault" in got and ["stop"] in got
    assert issubclass(PolicyFault, RuntimeError)
    assert SlowPolicy(base, delay_s=0.0)() == {"stop": False}


def test_video_prompt_adapter_8frame_wire_roundtrip():
    from sage3d_tpu_torch.serve.client import create_vlm_client
    seen = {}

    def fake_model(frames, prompt):
        seen["n_frames"] = len(frames)
        seen["prompt"] = prompt
        return "I should turn left 30 degrees."

    adapter = VideoPromptAdapter(fake_model, num_video_frames=8)
    with MLLMServer(adapter, port=0) as srv:
        client = create_vlm_client(model_name="navila", host="127.0.0.1",
                                   port=srv.port)
        resp = client.query([np.zeros((16, 16, 3), np.uint8)],
                            "go to the kitchen", current_yaw=0.0)
    assert seen["n_frames"] == 8
    assert seen["prompt"].count("<image>") == 8
    assert '"go to the kitchen"' in seen["prompt"]
    assert resp["yaw_rate"] > 0 and not resp["stop"]


def test_video_prompt_adapter_frame_normalization():
    from sage3d_tpu.serve.mllm_server import VideoPromptAdapter as JVideo
    ad = VideoPromptAdapter(lambda f, p: "stop", num_video_frames=4)
    jad = JVideo(lambda f, p: "stop", num_video_frames=4)
    assert ad.normalize_frames([]) == []
    assert ad.normalize_frames([1, 2]) == [1, 1, 1, 2]
    assert ad.normalize_frames([1, 2, 3, 4, 5, 6]) == [3, 4, 5, 6]
    assert ad.build_video_prompt("x") == jad.build_video_prompt("x")


# -- the CNN policy -----------------------------------------------------------

def _jax_params(height, width, frames, seed=1):
    """The JAX module's parameters as numpy, with non-zero biases; fc_w is
    drawn at the flattened size the SAME convolutions give (the JAX
    initializer's ``n // 8`` is short of it on sizes that are not multiples
    of 8, where only the apply function is defined)."""
    p = {k: np.array(v) for k, v in jp.init_cnn_policy(
        jax.random.PRNGKey(seed), height, width, frames).items()}
    rng = np.random.default_rng(seed)
    h, w = height, width
    for _ in range(3):
        h, w = -(-h // 2), -(-w // 2)
    flat = h * w * 64
    p["fc_w"] = (rng.standard_normal((flat, 128))
                 * np.sqrt(2.0 / flat)).astype(np.float32)
    for k in p:
        if k.endswith("_b"):
            p[k] = (0.1 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("height,width,frames", [(32, 32, 2), (96, 128, 4),
                                                 (30, 30, 2)])
def test_cnn_policy_matches_jax(height, width, frames):
    pj = _jax_params(height, width, frames)
    pt = tp.cnn_params_from_jax(pj, device="cpu")
    rng = np.random.default_rng(height + frames)
    for _ in range(3):
        x = rng.random((frames, height, width, 3), dtype=np.float32)
        want = np.array(jp.cnn_policy_apply(pj, x))
        got = tp.cnn_policy_apply(pt, torch.from_numpy(x)).numpy()
        assert got.shape == (len(tp.ACTIONS),)
        assert np.abs(got - want).max() <= CNN_REL * np.abs(want).max()


def test_same_padding_rule():
    """XLA's SAME at stride 2, window 3: 0 before and 1 after on even
    sides, 1 and 1 on odd ones; and padding=1 is not it on even sides."""
    assert tp._same_pad(96) == (0, 1) and tp._same_pad(48) == (0, 1)
    assert tp._same_pad(15) == (1, 1) and tp._same_pad(1) == (1, 1)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 6, 8, 10), dtype=np.float32))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6, 3, 3)).astype(np.float32))
    same = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x, (0, 1, 0, 1)), w, stride=2)
    one = torch.nn.functional.conv2d(x, w, stride=2, padding=1)
    assert same.shape == one.shape and not torch.allclose(same, one)


def test_cnn_policy_init_layout_and_module():
    p = tp.init_cnn_policy(96, 128, 4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert p["conv0_w"].shape == (16, 12, 3, 3)
    assert p["fc_w"].shape == (128, 12 * 16 * 64)
    q = tp.init_cnn_policy(96, 128, 4, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], q[k]) for k in p)
    x = torch.rand(3, 4, 96, 128, 3, generator=torch.Generator().manual_seed(2))
    batched = tp.CNNPolicy(p)(x)
    for i in range(3):
        assert torch.allclose(batched[i], tp.cnn_policy_apply(p, x[i]),
                              rtol=1e-5, atol=1e-6)


def test_prep_frames_equals_jax():
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
            for _ in range(2)]
    for images in ([], imgs, [Image.fromarray(imgs[0])]):
        got = tp.prep_frames(images, 24, 32, 4)
        want = jp.prep_frames(images, 24, 32, 4)
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_torch_policy_server_wire_roundtrip():
    from sage3d_tpu_torch.serve.client import create_vlm_client
    params = tp.init_cnn_policy(32, 32, 2, device="cpu")
    logits = tp.cnn_policy_apply(params, torch.zeros(2, 32, 32, 3))
    assert logits.shape == (len(tp.ACTIONS),)
    with tp.make_torch_policy_server(port=0, params=params, height=32,
                                     width=32, frames=2,
                                     device="cpu") as srv:
        client = create_vlm_client(input_type="rgb", output_type="text",
                                   protocol="socket", host="127.0.0.1",
                                   port=srv.port)
        img = np.zeros((16, 16, 3), np.uint8)
        resp = client.query([img], "go forward", current_yaw=0.0)
    assert "error" not in resp
    assert srv.stats["requests"] == 1
    want = tp.ACTIONS[int(torch.argmax(tp.cnn_policy_apply(
        params, torch.from_numpy(tp.prep_frames([img], 32, 32, 2)))))]
    assert srv.adapter.generate_response([img], "go") == want


def test_batch_policy_server_microbatches_concurrent_clients():
    from sage3d_tpu_torch.serve.batch_server import from_torch_policy
    from sage3d_tpu_torch.serve.client import create_vlm_client

    with from_torch_policy(height=32, width=32, frames=2, max_batch=4,
                           max_wait_s=0.2, device="cpu") as srv:
        results = {}

        def one(i):
            client = create_vlm_client(input_type="rgb", output_type="text",
                                       protocol="socket", host="127.0.0.1",
                                       port=srv.port)
            img = np.full((16, 16, 3), i * 10, np.uint8)
            results[i] = client.query([img], "go", current_yaw=0.0)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)

    assert len(results) == 6
    assert all("error" not in r for r in results.values())
    assert srv.stats["requests"] == 6
    assert srv.stats["batches"] < 6
    assert srv.stats["max_batch_seen"] >= 2


def test_batched_answers_equal_single_answers():
    """Batches run at their own size (no padding to max_batch): each
    request's answer equals the unbatched policy's."""
    from sage3d_tpu_torch.serve.batch_server import from_torch_policy
    params = tp.init_cnn_policy(32, 32, 2, device="cpu",
                                generator=torch.Generator().manual_seed(5))
    srv = from_torch_policy(params=params, height=32, width=32, frames=2,
                            max_batch=8, device="cpu")
    try:
        x = np.random.default_rng(0).random((5, 2, 32, 32, 3),
                                            dtype=np.float32)
        got = srv.batch_fn(x)
        want = [tp.ACTIONS[int(torch.argmax(tp.cnn_policy_apply(
            params, torch.from_numpy(f))))] for f in x]
        assert got == want
    finally:
        srv.stop()
