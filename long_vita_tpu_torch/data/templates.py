"""Chat prompt-template registry.

Counterpart of long_vita_tpu/data/templates.py (the reference's template
library, long_vita_megatron/tasks/preprocess/templates.py:91-543, consumed
when --prompt-type is set). Long-VITA ships only the Qwen2.5/ChatML path, so
ChatML is the default; llama2, llama3, vicuna and mistral give the same
breadth of --prompt-type choices. Every renderer gives the JAX package's
string for the same messages (tests/test_torch_dataset.py).
"""
from __future__ import annotations

from typing import Callable, Optional

Messages = list[dict]
Renderer = Callable[[Messages, bool], str]

_REGISTRY: dict[str, Renderer] = {}


def register(name: str):
    def deco(fn: Renderer) -> Renderer:
        _REGISTRY[name] = fn
        return fn

    return deco


def get_template(name: str) -> Renderer:
    return _REGISTRY[name]


def available_templates() -> list[str]:
    return sorted(_REGISTRY)


def render(name: str, messages: Messages,
           add_generation_prompt: bool = True) -> str:
    return _REGISTRY[name](messages, add_generation_prompt)


def _system(messages: Messages, default: Optional[str]) -> tuple[Optional[str], Messages]:
    if messages and messages[0]["role"] == "system":
        return messages[0]["content"], messages[1:]
    return default, messages


@register("qwen")
@register("chatml")
def chatml(messages: Messages, add_generation_prompt: bool = True) -> str:
    sys_msg, rest = _system(
        messages,
        "You are Qwen, created by Alibaba Cloud. You are a helpful assistant.",
    )
    out = ""
    if sys_msg is not None:
        out += f"<|im_start|>system\n{sys_msg}<|im_end|>\n"
    for m in rest:
        out += f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
    if add_generation_prompt:
        out += "<|im_start|>assistant\n"
    return out


@register("llama2")
def llama2(messages: Messages, add_generation_prompt: bool = True) -> str:
    sys_msg, rest = _system(messages, None)
    out = ""
    pending_user = None
    for m in rest:
        if m["role"] in ("user", "human"):
            content = m["content"]
            if sys_msg is not None and pending_user is None and not out:
                content = f"<<SYS>>\n{sys_msg}\n<</SYS>>\n\n{content}"
            pending_user = content
        else:
            out += f"<s>[INST] {pending_user} [/INST] {m['content']} </s>"
            pending_user = None
    if add_generation_prompt and pending_user is not None:
        out += f"<s>[INST] {pending_user} [/INST]"
    return out


@register("llama3")
def llama3(messages: Messages, add_generation_prompt: bool = True) -> str:
    out = "<|begin_of_text|>"
    for m in messages:
        out += (
            f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
            f"{m['content']}<|eot_id|>"
        )
    if add_generation_prompt:
        out += "<|start_header_id|>assistant<|end_header_id|>\n\n"
    return out


@register("vicuna")
def vicuna(messages: Messages, add_generation_prompt: bool = True) -> str:
    sys_msg, rest = _system(
        messages,
        "A chat between a curious user and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the user's questions.",
    )
    out = (sys_msg + " ") if sys_msg else ""
    for m in rest:
        if m["role"] in ("user", "human"):
            out += f"USER: {m['content']} "
        else:
            out += f"ASSISTANT: {m['content']}</s>"
    if add_generation_prompt:
        out += "ASSISTANT:"
    return out


@register("mistral")
def mistral(messages: Messages, add_generation_prompt: bool = True) -> str:
    _, rest = _system(messages, None)
    out = "<s>"
    pending = None
    for m in rest:
        if m["role"] in ("user", "human"):
            pending = m["content"]
        else:
            out += f"[INST] {pending} [/INST]{m['content']}</s>"
            pending = None
    if add_generation_prompt and pending is not None:
        out += f"[INST] {pending} [/INST]"
    return out
