"""HTTP client for the inference server.

Counterpart of long_vita_tpu/inference/client.py (reference
long_vita_megatron/inference_long_vita.py:27-65): PUT {url}/api with prompts
+ media path lists; answer = response["text"][0]. The same wire format, on
the standard library's urllib instead of ``requests``.
"""
from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Optional, Sequence


def _put(url: str, payload: dict, timeout: float):
    """Open a PUT of ``payload``; raises RuntimeError on a non-200 answer."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="PUT",
    )
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"server error {e.code}: {e.read().decode()}") from None


def generate(
    prompt: str,
    *,
    url: Optional[str] = None,
    image_path_list: Sequence[str] = (),
    video_path_list: Sequence[str] = (),
    tokens_to_generate: int = 256,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    max_num_frame: Optional[int] = None,
    timeout: float = 600.0,
) -> str:
    url = url or os.environ.get("LongVITA_URL", "http://127.0.0.1:5001/api")
    payload = {
        "prompts": [prompt],
        "image_path_list": list(image_path_list) or None,
        "video_path_list": list(video_path_list) or None,
        "tokens_to_generate": tokens_to_generate,
    }
    if temperature is not None:
        payload["temperature"] = temperature
    if top_k is not None:
        payload["top_k"] = top_k
    if top_p is not None:
        payload["top_p"] = top_p
    if max_num_frame is not None:
        payload["max_num_frame"] = max_num_frame
    with _put(url, payload, timeout) as resp:
        return json.loads(resp.read())["text"][0]


def generate_stream(
    prompt: str,
    *,
    url: Optional[str] = None,
    tokens_to_generate: int = 256,
    timeout: float = 600.0,
    **kwargs,
):
    """Streaming generate against a --continuous server: yields text deltas
    as they decode; the final full text is the concatenation. Extra kwargs
    ride into the request payload (temperature/top_k/top_p/...)."""
    url = url or os.environ.get("LongVITA_URL", "http://127.0.0.1:5001/api")
    payload = {
        "prompts": [prompt],
        "tokens_to_generate": tokens_to_generate,
        "stream": True,
        **kwargs,
    }
    with _put(url, payload, timeout) as resp:
        for line in resp:
            if not line.strip():
                continue
            ev = json.loads(line)
            if ev.get("error"):
                raise RuntimeError(ev["error"])
            if ev.get("done"):
                return
            yield ev["delta"]
