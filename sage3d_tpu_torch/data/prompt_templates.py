"""Few-shot prompt template system for the LLM pipeline stages.

The reference ships its LLM prompts as JSON message lists with {placeholder}
slots, loaded at startup (vln_trajectory_generator.py:236-239, 2306-2309;
prompts/prompt_phy_to_sem.json) — the output distribution of the instruction
data depends on them. This module provides the same mechanism: packaged
templates (prompts/*.json beside this module, a copy of the JAX
package's set), a loader, and a renderer that
substitutes placeholders without touching literal braces elsewhere in the
text (templates contain JSON examples, so str.format is unusable).

Templates (same roles/placeholders/output contracts as the reference set):
  * prompt_pairwise_judgement       — {scene_map}, {start_item}, {end_item} ->
    JSON object {meaningful} (single-pair variant, non-batched judging)
  * prompt_pairwise_judgement_batch — {scene_map}, {pairs_list} ->
    JSON array [{pair_id, start, end, meaningful}]
  * prompt_traj_to_instruction     — {text}{json} ->
    JSON array [{instruction_type, start, end, generated_instruction}]
  * prompt_phy_to_sem              — few-shot (user/assistant example) +
    {json} -> plain-text semantic map
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

PROMPTS_DIR = Path(__file__).parent / "prompts"

# The template-driven instruction taxonomy (prompt_traj_to_instruction):
# these are the five typed families of SAGE-Bench (BASELINE.md Fig.6:
# AC / SD / RR / Att / Ar).
INSTRUCTION_TYPES = ("Add_Object", "Scenario_Driven", "Relative_Relationship",
                     "Attribute-based", "Area-based")
INSTRUCTIONS_PER_TYPE = (2, 4)   # the template asks for 2-4 per type


def load_prompt_template(name_or_path) -> List[Dict[str, str]]:
    """Load a message-list template by packaged name or explicit path."""
    path = Path(name_or_path)
    if not path.exists():
        path = PROMPTS_DIR / f"{name_or_path}.json"
    if not path.exists():
        raise FileNotFoundError(f"prompt template not found: {name_or_path}")
    with open(path, encoding="utf-8") as f:
        template = json.load(f)
    assert isinstance(template, list) and all(
        "role" in m and "content" in m for m in template), \
        f"malformed template {path}: expected a message list"
    return template


def render_template(template: List[Dict[str, str]],
                    **substitutions) -> List[Dict[str, str]]:
    """Substitute {key} slots in message contents (plain replace, so literal
    braces in few-shot JSON examples survive)."""
    out = []
    for msg in template:
        content = msg["content"]
        for key, value in substitutions.items():
            content = content.replace("{" + key + "}", str(value))
        out.append({"role": msg["role"], "content": content})
    return out


def pairwise_judgement_messages(scene_map: str,
                                pairs) -> List[Dict[str, str]]:
    listing = json.dumps([{"pair_id": i, "start": s, "end": e}
                          for i, (s, e) in enumerate(pairs)], indent=1)
    return render_template(
        load_prompt_template("prompt_pairwise_judgement_batch"),
        scene_map=scene_map, pairs_list=listing)


def pairwise_judgement_single_messages(scene_map: str, start_item: str,
                                       end_item: str) -> List[Dict[str, str]]:
    """Single-pair judgement messages (reference ships this as a separate
    template next to the batch one; same rules, one verdict per call)."""
    return render_template(
        load_prompt_template("prompt_pairwise_judgement"),
        scene_map=scene_map, start_item=start_item, end_item=end_item)


def traj_to_instruction_messages(scene_text: str, start_item: str,
                                 end_item: str) -> List[Dict[str, str]]:
    payload = json.dumps({"text_map": scene_text, "starting_point": start_item,
                          "end_point": end_item}, indent=1)
    return render_template(
        load_prompt_template("prompt_traj_to_instruction"),
        text="", json=payload)


def phy_to_sem_messages(scene_entries: Dict[str, str]) -> List[Dict[str, str]]:
    return render_template(
        load_prompt_template("prompt_phy_to_sem"),
        json=json.dumps(scene_entries, indent=1))
