"""The port's forward entry point, the counterpart of ``__graft_entry__.entry``.

    from streamspeech_tpu_torch.entry import entry
    fn, args = entry()            # on the card; entry("cpu") on the CPU
    unit_logits = fn(*args)

``fn`` is the offline (teacher-forced) forward of the flagship StreamSpeech
model (``full_config``: 12-layer d256 conformer, 4-layer d512 MT decoder,
2-layer T2U, 2-layer NAR unit decoder ×25, 1005 units) with random weights
from seed 0, eval mode, chunk 8 streaming masks and n2=1; it returns the unit
logits. The example arguments are ``__graft_entry__.entry``'s: one utterance
of 256 fbank frames and an MT prefix of 16 tokens.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from streamspeech_tpu_torch.config import StreamSpeechConfig, full_config
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.weights import random_init_


def entry(device="cuda", cfg: Optional[StreamSpeechConfig] = None
          ) -> Tuple[Callable[..., torch.Tensor], tuple]:
    """(fn, example_args): ``fn(model, src, lens, mt)`` → unit logits
    [1, 16 × upsample, units] ([1, 400, 1005] at ``full_config``, the default
    ``cfg``); the model and inputs lie on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device is available; pass device='cpu'")
    cfg = full_config() if cfg is None else cfg
    model = random_init_(StreamSpeechModel(cfg), 0).eval().to(device)
    b, frames, mt_len = 1, 256, 16
    src = torch.zeros((b, frames, 80), dtype=torch.float32, device=device)
    lens = torch.full((b,), frames, dtype=torch.long, device=device)
    mt = torch.full((b, mt_len), 4, dtype=torch.long, device=device)

    @torch.no_grad()
    def fn(model, src, lens, mt):
        return model(src, lens, mt, chunk_size=8, conv_chunk_size=8,
                     n2=1)["unit_logits"]

    return fn, (model, src, lens, mt)
