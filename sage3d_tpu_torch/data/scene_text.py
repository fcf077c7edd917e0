"""Scene text generation: scene.json AABBs -> natural-language scene map.

Re-implementation of the reference stage (scene_text_generator.py:59-287):
scene.json entries are serialized into a prompt and sent through an LLM client
(OpenAI-compatible or MockLLMClient) with a thread pool across scenes and
retry-on-failure; outputs land as semantic_map_{scene}.txt.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

from .llm import LLMClient, MockLLMClient

WORKERS = 16  # scene_text_generator.py:260-287 thread pool


def build_messages(scene_entries: Dict[str, str]) -> List[Dict[str, str]]:
    """Few-shot phy->sem template (prompts/prompt_phy_to_sem.json, mirroring
    the reference's loaded prompt scene_text_generator.py + prompt_phy_to_sem):
    system rules + one worked user/assistant example + the scene payload."""
    from .prompt_templates import phy_to_sem_messages
    return phy_to_sem_messages(scene_entries)


def process_scene(scene_key: str, scene_json_path, output_dir,
                  client: Optional[LLMClient] = None,
                  overwrite: bool = False) -> Optional[Path]:
    """One scene: scene.json -> semantic_map_{scene}.txt (resume-aware)."""
    client = client or MockLLMClient()
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    out = output_dir / f"semantic_map_{scene_key}.txt"
    if out.exists() and not overwrite:
        return out
    with open(scene_json_path) as f:
        entries = json.load(f)
    text = client.chat_with_retry(build_messages(entries))
    if text is None:
        return None
    out.write_text(text)
    return out


def process_all(scene_jsons: Dict[str, str], output_dir,
                client: Optional[LLMClient] = None, overwrite: bool = False,
                max_scenes: Optional[int] = None) -> List[Path]:
    """Thread-pooled batch over {scene_key: scene.json path}."""
    items = sorted(scene_jsons.items())
    if max_scenes is not None:
        items = items[:max_scenes]
    results: List[Optional[Path]] = []
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        futures = [pool.submit(process_scene, k, p, output_dir, client,
                               overwrite) for k, p in items]
        for fut in futures:
            results.append(fut.result())
    return [r for r in results if r is not None]
