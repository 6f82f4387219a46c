"""VLMEvalKit adapter for the port's inference server.

Counterpart of long_vita_tpu/eval/vlmeval_adapter.py (reference VLMEvalKit/
long_vita.py, LongVITAAPI): VLMEvalKit messages (text, image and video
parts) are rendered into one prompt with <image>/<video> placeholders and
per-dataset answer-style suffixes, then PUT to the server through
inference/client.py; the reply's tail after "Answer:" is the answer.

Register inside a VLMEvalKit checkout with:

    from vlmeval.config import supported_VLM
    from functools import partial
    from long_vita_tpu_torch.eval.vlmeval_adapter import LongVITAAPI
    supported_VLM["LongVITA"] = partial(LongVITAAPI)

and set LongVITA_URL (default http://127.0.0.1:5001/api). Host code only:
no kernel runs here.
"""
from __future__ import annotations

import os
from typing import Optional

from long_vita_tpu_torch.inference import client

# datasets grouped by answer style (reference long_vita.py:92-140)
_MCQ_LETTER_DIRECT = {"MMMU_DEV_VAL", "MMMU_TEST", "MMStar"}
_SINGLE_PHRASE = {"MathVista_MINI"}


def _dataset_type(dataset: Optional[str]) -> Optional[str]:
    """VLMEvalKit's answer type of ``dataset``, or None without VLMEvalKit."""
    try:
        from vlmeval.dataset import DATASET_TYPE  # type: ignore

        return DATASET_TYPE(dataset)
    except Exception:
        return None


def build_prompt(parts: list[dict], dataset: Optional[str] = None):
    """-> (prompt_text, image_path_list, video_path_list)."""
    text = ""
    image_paths: list[str] = []
    video_paths: list[str] = []
    for part in parts:
        kind = part["type"]
        if kind == "text":
            text += part["value"]
        elif kind == "image":
            image_paths.append(part["value"])
            # Video-MME ships frames as images: feed them as a video stream
            text += "<video>" if dataset == "Video-MME" else "<image>\n"
        elif kind == "video":
            video_paths.append(part["value"])
            text += "<video>"
        else:
            raise ValueError(f"invalid message part type: {kind}")

    text = text.replace("\nAnswer: ", "\n")
    dtype = _dataset_type(dataset)

    if dataset == "OCRBench":
        text += ("\nAnswer this question using the text in the image "
                 "directly without any other context.")
    elif dataset in _MCQ_LETTER_DIRECT:
        text = text.replace(
            "Please select the correct answer from the options above.", ""
        ).strip() + "\n"
        text += "Answer with the option's letter from the given choices directly."
    elif dataset == "MVBench":
        text = text.replace("Only give the best option.Best option:(", "")
        text += "Answer with the letter."
    elif dataset == "MMVet":
        pass
    elif dataset in _SINGLE_PHRASE:
        text += "\nAnswer the question using a single word or phrase."
    elif dtype == "Y/N":
        text = text.replace("Answer the question with Yes or No.", "").strip() + "\n"
        text += "Answer yes or no."
    elif dtype == "MCQ":
        text = text.replace(
            "Please select the correct answer from the options above.", ""
        ).strip() + "\n"
        text += "Answer with the letter."
    elif dtype == "VQA":
        pass
    elif dtype == "Video-MCQ":
        text += "Offer a very short reply."
    else:
        text = text.replace(
            "Answer the question using a single word or phrase.", ""
        ).strip() + "\n"
        text += "Answer the question using a single word or phrase."
    return text, image_paths, video_paths


def postprocess_answer(answer: str) -> str:
    if "Answer:" in answer:
        answer = answer.split("Answer:")[-1].strip()
    return answer


class _ServerModel:
    """The generate_inner both adapter modes share."""

    def __init__(self, url: Optional[str] = None, tokens_to_generate: int = 256):
        self.url = url or os.environ.get("LongVITA_URL", "http://127.0.0.1:5001/api")
        self.tokens_to_generate = tokens_to_generate

    def generate_inner(self, inputs, **kwargs):
        parts = [inputs] if isinstance(inputs, str) else inputs
        parts = [{"type": "text", "value": p} if isinstance(p, str) else p for p in parts]
        prompt, images, videos = build_prompt(parts, kwargs.get("dataset"))
        max_num_frame = os.environ.get("MAX_NUM_FRAME")
        try:
            answer = client.generate(
                prompt,
                url=self.url,
                image_path_list=images,
                video_path_list=videos,
                tokens_to_generate=self.tokens_to_generate,
                max_num_frame=int(max_num_frame) if max_num_frame else None,
            )
        except Exception as e:  # noqa: BLE001 (VLMEvalKit's API contract: a code, not a raise)
            return -1, f"Failed to obtain answer via API. {e}", ""
        return 0, postprocess_answer(answer), "Succeeded! "


try:  # the full adapter where VLMEvalKit is installed
    from vlmeval.api.base import BaseAPI  # type: ignore

    class LongVITAAPI(BaseAPI, _ServerModel):  # type: ignore[misc]
        is_api = True

        def __init__(self, url=None, tokens_to_generate=256, **kwargs):
            _ServerModel.__init__(self, url, tokens_to_generate)
            BaseAPI.__init__(self, **kwargs)

except ImportError:  # standalone: the same generate_inner contract
    LongVITAAPI = _ServerModel  # type: ignore[assignment]
