"""Text conditioning (counterpart of ``topiaxl/models/conditioner/text.py``).

``CLIPTextEncoder`` encodes tokenised captions with the CLIP text tower
(``conditioner/clip.py``) into [B, 1, D] conditioning: the pooled output,
one token per caption. Its weights come from a local transformers-layout
directory (``model_name_or_path``); with one and no ``tokenizer`` it
takes ``transformers.CLIPTokenizerFast`` from the same directory, imported
only then. ``TextConditioner`` holds the encoder, or, with ``stub=True``,
the JAX package's hash embedding: per caption, N(0, 1) draws of numpy's
``default_rng(abs(hash(text)) % 2**32)``. Python salts ``hash(str)`` per
process unless ``PYTHONHASHSEED`` is set, so the stub's embedding of a
caption changes between processes, in the JAX package as here.
"""

from __future__ import annotations

import numpy as np
import torch

from .clip import load_clip_tower


class CLIPTextEncoder(torch.nn.Module):
    """CLIP text tower -> pooled [B, 1, D] conditioning."""

    def __init__(self, tower: torch.nn.Module | None = None, tokenizer=None,
                 model_name_or_path: str | None = None, device=None):
        super().__init__()
        if model_name_or_path:
            tower = load_clip_tower(model_name_or_path, "text", device=device)
            if tokenizer is None:
                from transformers import CLIPTokenizerFast

                tokenizer = CLIPTokenizerFast.from_pretrained(
                    model_name_or_path)
        self.tower = tower
        self.tokenizer = tokenizer

    def encode_ids(self, input_ids) -> torch.Tensor:
        dev = next(self.tower.parameters()).device
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=dev)
        return self.tower(ids)["pooled"][:, None, :]

    def forward(self, texts) -> torch.Tensor:
        if self.tokenizer is None:
            raise RuntimeError(
                "CLIPTextEncoder needs a tokenizer (pass tokenizer= or "
                "model_name_or_path= pointing at local CLIP files)")
        ids = self.tokenizer(list(texts), padding="max_length",
                             truncation=True, return_tensors="np")
        return self.encode_ids(ids["input_ids"])


class TextConditioner(torch.nn.Module):
    """Captions -> [B, 1, D] conditioning through ``encoder``; without one,
    ``stub=True`` opts into the hash embedding (f32, on ``device``), and
    anything else raises, as in the JAX package: a config that claims
    CLIP text conditioning must not run on made-up embeddings."""

    def __init__(self, encoder: torch.nn.Module | None = None, dim: int = 768,
                 stub: bool = False, device=None):
        super().__init__()
        self.dim = dim
        self.encoder = encoder
        self.stub = bool(stub)
        self.device = torch.device(device if device is not None else "cpu")
        if encoder is None and not self.stub:
            raise ValueError(
                "TextConditioner has no encoder: pass encoder= (a "
                "CLIPTextEncoder with local weights) or opt into the "
                "hash-embedding stub explicitly with stub=True "
                "(`stub: true` in config)")

    def stub_embed(self, texts) -> torch.Tensor:
        out = [np.random.default_rng(abs(hash(t)) % (2 ** 32))
               .standard_normal(self.dim).astype(np.float32) for t in texts]
        return torch.from_numpy(np.stack(out)[:, None, :]).to(self.device)

    def forward(self, texts) -> torch.Tensor:
        if self.encoder is not None:
            return self.encoder(texts)
        return self.stub_embed(list(texts))
