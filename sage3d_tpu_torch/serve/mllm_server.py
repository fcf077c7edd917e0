"""Generic multimodal-model VLN server: adapter pattern over the wire protocol.

The port's copy of ``sage3d_tpu/serve/mllm_server.py``. The HuggingFace
adapters take ``device=None``, which means the card (``"cuda"``), where the
JAX package's default to ``"cpu"``; they raise without a card unless the
caller passes ``device="cpu"``.

Re-implementation of the reference MLLM server (mllm_server.py:41-519): a
socket server (8-byte BE length + JSON, base64 JPEG frames) that hosts ANY
vision-language model behind an adapter exposing
``generate_response(images, instruction) -> text``; the response text is
constrained-decoded to the 4-action vocabulary with partial matching
(mllm_server.py:89-112). HuggingFace adapters (Qwen-VL / LLaVA / InternVL
prompt shapes, :125-367) are provided but imported lazily — the harness runs
with a plain callable, and the CNN policy of ``serve/torch_policy.py``
serves from the card.
"""

from __future__ import annotations

import socket
import threading
import time
from abc import ABC, abstractmethod
from typing import Callable, List, Optional

from .protocol import decode_image_b64, recv_framed, send_framed


def _device(device: Optional[str]) -> str:
    """``None`` means the card; raises when there is none."""
    from ..renderer.scene import resolve_device
    return str(resolve_device(device))

ACTIONS = ("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT", "STOP")


class VLNPromptTemplate:
    """Constrained 4-action prompt (mllm_server.py:41-66)."""

    SYSTEM = (
        "You are a robot navigating inside a building. Given the current "
        "first-person view and an instruction, choose EXACTLY ONE action from: "
        "MOVE_FORWARD, TURN_LEFT, TURN_RIGHT, STOP. Reply with the action only.")

    @classmethod
    def user(cls, instruction: str) -> str:
        return (f"Instruction: {instruction}\n"
                f"Which action should the robot take next?")

    @classmethod
    def build(cls, instruction: str) -> str:
        return f"{cls.SYSTEM}\n\n{cls.user(instruction)}"


def extract_action(text: str) -> str:
    """Map free-form model output to the closest action, with partial matching
    (mllm_server.py:89-112). Unknown output -> MOVE_FORWARD (navid_server.py:
    326-327 default-forward convention)."""
    t = text.upper()
    for action in ACTIONS:
        if action in t:
            return action
    t_low = text.lower()
    if "stop" in t_low or "done" in t_low or "finish" in t_low:
        return "STOP"
    if "left" in t_low:
        return "TURN_LEFT"
    if "right" in t_low:
        return "TURN_RIGHT"
    if "forward" in t_low or "ahead" in t_low or "straight" in t_low \
            or "move" in t_low:
        return "MOVE_FORWARD"
    return "MOVE_FORWARD"


class MLLMAdapter(ABC):
    """Model adapter: decode images + instruction -> raw text."""

    @abstractmethod
    def generate_response(self, images: List, instruction: str) -> str: ...

    def extract_action(self, text: str) -> str:
        return extract_action(text)


class CallableAdapter(MLLMAdapter):
    """Wrap any (images, instruction) -> text callable (incl. in-process policies)."""

    def __init__(self, fn: Callable[[List, str], str]):
        self.fn = fn

    def generate_response(self, images, instruction):
        return self.fn(images, instruction)


class VideoPromptAdapter(MLLMAdapter):
    """NaVILA-class multi-frame video-prompt hosting (navila_server.py:264-315).

    Normalizes the incoming frame history to ``num_video_frames`` (front-pad
    by repeating the first frame, keep the most recent on overflow — the
    8-frame sliding-buffer contract of RGBInputProcessor,
    vlm_client_modular.py:54-82), builds the reference's video prompt with
    one image slot per history frame plus the current observation, and calls
    ``model_fn(frames, prompt) -> text``. The raw text is returned verbatim:
    NaVILA-style servers reply free-form ("turn left 30 degrees", "move
    forward 75 cm"); the CLIENT parses it (TextOutputParser,
    vlm_client_modular.py:244-299 == serve/client.py).
    """

    IMAGE_TOKEN = "<image>\n"

    def __init__(self, model_fn: Callable[[List, str], str],
                 num_video_frames: int = 8):
        self.model_fn = model_fn
        self.num_video_frames = num_video_frames

    def normalize_frames(self, images: List) -> List:
        n = self.num_video_frames
        if not images:
            return []
        if len(images) < n:
            return [images[0]] * (n - len(images)) + list(images)
        return list(images[-n:])

    def build_video_prompt(self, instruction: str) -> str:
        tok = self.IMAGE_TOKEN
        return (
            "Imagine you are a robot programmed for navigation tasks. You "
            "have been given a video of historical observations "
            f"{tok * (self.num_video_frames - 1)}, and current observation "
            f'{tok}. Your assigned task is: "{instruction}" Analyze this '
            "series of images to decide your next action, which could be "
            "turning left or right by a specific degree, moving forward a "
            "certain distance, or stop if the task is completed.")

    def generate_response(self, images, instruction):
        frames = self.normalize_frames(images)
        prompt = self.build_video_prompt(instruction)
        return self.model_fn(frames, prompt)

    def extract_action(self, text: str) -> str:
        # NaVILA replies are parsed client-side; pass the raw text through.
        return text


class HFVideoAdapter(VideoPromptAdapter):
    """VideoPromptAdapter over a HuggingFace multimodal model: ALL frames go
    to the processor (one image content slot per frame), fixing the round-1
    single-image truncation."""

    def __init__(self, model_id: str, device: Optional[str] = None,
                 num_video_frames: int = 8, max_new_tokens: int = 64):
        from transformers import AutoModelForVision2Seq, AutoProcessor
        self.processor = AutoProcessor.from_pretrained(model_id)
        self.model = AutoModelForVision2Seq.from_pretrained(model_id)
        device = _device(device)
        self.model.to(device)
        self.device = device
        self.max_new_tokens = max_new_tokens

        def _fn(frames, prompt):
            messages = [{"role": "user", "content": (
                [{"type": "image"} for _ in frames]
                + [{"type": "text", "text": prompt}])}]
            text = self.processor.apply_chat_template(
                messages, add_generation_prompt=True)
            inputs = self.processor(text=text, images=frames,
                                    return_tensors="pt").to(self.device)
            out = self.model.generate(**inputs,
                                      max_new_tokens=self.max_new_tokens)
            return self.processor.batch_decode(
                out, skip_special_tokens=True)[-1]

        super().__init__(_fn, num_video_frames=num_video_frames)


class HFAdapter(MLLMAdapter):
    """HuggingFace multimodal adapter (Qwen-VL/LLaVA/InternVL families).

    Lazily loads transformers; prompt construction follows the per-family
    shapes of the reference adapters (mllm_server.py:125-367). Runs on the
    card unless ``device="cpu"``; model_id examples:
    Qwen/Qwen2-VL-2B-Instruct, llava-hf/llava-1.5-7b-hf.
    """

    def __init__(self, model_id: str, device: Optional[str] = None, max_new_tokens: int = 16):
        from transformers import AutoModelForVision2Seq, AutoProcessor
        self.processor = AutoProcessor.from_pretrained(model_id)
        self.model = AutoModelForVision2Seq.from_pretrained(model_id)
        device = _device(device)
        self.model.to(device)
        self.device = device
        self.max_new_tokens = max_new_tokens

    def generate_response(self, images, instruction):
        prompt = VLNPromptTemplate.build(instruction)
        messages = [{"role": "user", "content": (
            [{"type": "image"} for _ in images[:1]]
            + [{"type": "text", "text": prompt}])}]
        text = self.processor.apply_chat_template(messages,
                                                  add_generation_prompt=True)
        inputs = self.processor(text=text, images=images[:1],
                                return_tensors="pt").to(self.device)
        out = self.model.generate(**inputs, max_new_tokens=self.max_new_tokens)
        return self.processor.batch_decode(out, skip_special_tokens=True)[-1]


class QwenVLAdapter(MLLMAdapter):
    """Qwen-VL prompt shape (reference QwenVLAdapter, mllm_server.py:125-213):
    system + user CHAT messages through the processor's chat template, image
    content slot inline in the user turn, processor(text=[..], images=[..],
    padding=True), and decode of ONLY the newly generated ids (input trim).

    ``model``/``processor`` may be injected (tests use fakes — no weights);
    otherwise they load lazily from ``model_id``.
    """

    def __init__(self, model_id: str = "", device: Optional[str] = None,
                 max_new_tokens: int = 64, model=None, processor=None):
        if model is None or processor is None:
            from transformers import AutoModelForVision2Seq, AutoProcessor
            processor = AutoProcessor.from_pretrained(model_id,
                                                      trust_remote_code=True)
            model = AutoModelForVision2Seq.from_pretrained(
                model_id, trust_remote_code=True).to(_device(device))
        self.model = model
        self.processor = processor
        self.max_new_tokens = max_new_tokens

    def build_messages(self, image, instruction: str):
        content = ([{"type": "image", "image": image}] if image is not None
                   else [])
        content.append({"type": "text",
                        "text": VLNPromptTemplate.user(instruction)})
        return [
            {"role": "system", "content": VLNPromptTemplate.SYSTEM},
            {"role": "user", "content": content},
        ]

    def generate_response(self, images, instruction):
        image = images[-1] if images else None
        messages = self.build_messages(image, instruction)
        text = self.processor.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
        # text-only requests are legal on the wire (client.py sends them for
        # pure-instruction turns): no image slot, no images kwarg
        img_kw = {"images": [image]} if image is not None else {}
        inputs = self.processor(text=[text], return_tensors="pt",
                                padding=True, **img_kw)
        device = getattr(self.model, "device", None)
        if device is not None:
            inputs = inputs.to(device)
        out_ids = self.model.generate(**inputs,
                                      max_new_tokens=self.max_new_tokens)
        trimmed = [o[len(i):] for i, o in zip(inputs["input_ids"], out_ids)]
        return self.processor.batch_decode(trimmed,
                                           skip_special_tokens=True)[0]


class LLaVAAdapter(MLLMAdapter):
    """LLaVA conversation-template prompt shape (reference LLaVAAdapter,
    mllm_server.py:216-283): the literal ``USER: <image>\\n...ASSISTANT:``
    conversation string (LLaVA-1.5 was trained on this template, not on a
    tokenizer chat template), raw processor call, decode past the input ids.
    """

    PROMPT_FMT = "USER: <image>\n{system}\n\n{user}\nASSISTANT:"
    PROMPT_FMT_NOIMG = "USER: {system}\n\n{user}\nASSISTANT:"

    def __init__(self, model_id: str = "", device: Optional[str] = None,
                 max_new_tokens: int = 64, model=None, processor=None):
        if model is None or processor is None:
            from transformers import AutoModelForVision2Seq, AutoProcessor
            processor = AutoProcessor.from_pretrained(model_id,
                                                      trust_remote_code=True)
            model = AutoModelForVision2Seq.from_pretrained(
                model_id, trust_remote_code=True).to(_device(device))
        self.model = model
        self.processor = processor
        self.max_new_tokens = max_new_tokens

    def build_prompt(self, instruction: str, has_image: bool = True) -> str:
        fmt = self.PROMPT_FMT if has_image else self.PROMPT_FMT_NOIMG
        return fmt.format(system=VLNPromptTemplate.SYSTEM,
                          user=VLNPromptTemplate.user(instruction))

    def generate_response(self, images, instruction):
        image = images[-1] if images else None
        # text-only requests: drop the <image> token AND the images kwarg
        # (HF LLaVA processors raise on an <image> token with no pixels)
        img_kw = {"images": image} if image is not None else {}
        inputs = self.processor(
            text=self.build_prompt(instruction, has_image=image is not None),
            return_tensors="pt", **img_kw)
        device = getattr(self.model, "device", None)
        if device is not None:
            inputs = inputs.to(device)
        out_ids = self.model.generate(**inputs,
                                      max_new_tokens=self.max_new_tokens)
        n_in = inputs["input_ids"].shape[1]
        return self.processor.decode(out_ids[0][n_in:],
                                     skip_special_tokens=True)


class InternVLAdapter(MLLMAdapter):
    """InternVL prompt shape (reference InternVLAdapter, mllm_server.py:
    286-367): no processor — the model's own ``chat(tokenizer, pixel_values,
    prompt, config)`` entry point, fed 448x448 ImageNet-normalized pixel
    tensors built here (InternVL's dynamic-tiling preprocessing contract).
    """

    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)
    SIZE = 448

    def __init__(self, model_id: str = "", device: Optional[str] = None,
                 max_new_tokens: int = 32, model=None, tokenizer=None):
        if model is None or tokenizer is None:
            from transformers import AutoModel, AutoTokenizer
            tokenizer = AutoTokenizer.from_pretrained(model_id,
                                                      trust_remote_code=True)
            model = AutoModel.from_pretrained(
                model_id, trust_remote_code=True,
                low_cpu_mem_usage=True).to(_device(device))
        self.model = model
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens

    def preprocess(self, image):
        """PIL image -> (1, 3, 448, 448) ImageNet-normalized float tensor."""
        import numpy as np
        import torch
        if image.mode != "RGB":
            image = image.convert("RGB")
        image = image.resize((self.SIZE, self.SIZE))
        arr = np.asarray(image, dtype=np.float32) / 255.0        # (H, W, 3)
        arr = (arr - np.asarray(self.MEAN, np.float32)) / np.asarray(
            self.STD, np.float32)
        return torch.from_numpy(arr.transpose(2, 0, 1))[None]

    def generate_response(self, images, instruction):
        pixel_values = self.preprocess(images[-1]) if images else None
        if pixel_values is not None:
            device = getattr(self.model, "device", None)
            if device is not None:
                pixel_values = pixel_values.to(device)
        config = {"max_new_tokens": self.max_new_tokens,
                  "pad_token_id": getattr(self.tokenizer, "eos_token_id",
                                          None)}
        return self.model.chat(self.tokenizer, pixel_values,
                               VLNPromptTemplate.build(instruction), config)


MODEL_ADAPTERS = {
    "qwen": QwenVLAdapter,
    "llava": LLaVAAdapter,
    "internvl": InternVLAdapter,
}


def make_hf_adapter(model_id: str, family: str = "", **kw) -> MLLMAdapter:
    """Pick the model-specific adapter by ``family`` or by model-id sniffing;
    unknown families fall back to the generic HFAdapter."""
    fam = (family or model_id).lower()
    for key, cls in MODEL_ADAPTERS.items():
        if key in fam:
            return cls(model_id=model_id, **kw)
    return HFAdapter(model_id, **kw)


class MLLMServer:
    """Socket VLN server hosting an adapter (mllm_server.py:370-519)."""

    def __init__(self, adapter: MLLMAdapter, host: str = "0.0.0.0",
                 port: int = 54321, verbose: bool = False):
        self.adapter = adapter
        self.host = host
        self.verbose = verbose
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(8)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"requests": 0, "total_latency_s": 0.0}

    def _handle(self, conn: socket.socket) -> None:
        request = recv_framed(conn)
        if request.get("action") == "reset":
            send_framed(conn, {"result": "reset_ok"})
            return
        images = [decode_image_b64(b) for b in request.get("images", [])]
        instruction = request.get("query", request.get("instruction", ""))
        t0 = time.time()
        raw = self.adapter.generate_response(images, instruction)
        action = self.adapter.extract_action(raw)
        self.stats["requests"] += 1
        self.stats["total_latency_s"] += time.time() - t0
        send_framed(conn, {"result": action, "raw": str(raw)[:500]})

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                conn.settimeout(120.0)
                self._handle(conn)
            except Exception as e:
                if self.verbose:
                    print(f"[MLLM_SERVER] request failed: {e}")
                # Best-effort framed error reply so the client gets a STOP
                # with a reason instead of blocking on recv until its own
                # timeout (the reference client maps errors to stop too).
                try:
                    send_framed(conn, {"result": "STOP",
                                       "error": str(e)[:200]})
                except Exception:
                    pass
            finally:
                conn.close()

    def start(self) -> "MLLMServer":
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.start()
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
