"""Text embeddings over the LayoutLM encoder (port of
``marie_tpu/embeddings/layout_embeddings.py``): the text-only encoder
(``use_image=False``) over hash-word tokens, batches padded to a few
fixed sizes, the final states mean-pooled over each text's words and L2
normalised.

Weights: a flax-layout numpy tree of the bare encoder (``params``,
through :mod:`marie_tpu_torch.registry.convert`); without one they are
drawn from ``init_flax_layout(config, seed, "encoder")``.  The JAX class
draws its default from ``jax.random.PRNGKey(0)``, which the port cannot
repeat, so two defaults are different models: hand both packages the
same tree to compare them.
"""

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from marie_tpu_torch.components.word_tokenizer import HashWordTokenizer
from marie_tpu_torch.embeddings.base import EmbeddingsBase
from marie_tpu_torch.models.configs import LayoutLMConfig
from marie_tpu_torch.ops.kernels._build import launch_path
from marie_tpu_torch.preprocess.buckets import pad_batch
from marie_tpu_torch.registry.convert import init_flax_layout, load_model
from marie_tpu_torch.utils.device import float32_precision, resolve_device


class LayoutEmbeddingsModel(EmbeddingsBase):
    """Port-only keywords: ``seed`` (the default tree's) and ``device``."""

    def __init__(
        self,
        config: Optional[LayoutLMConfig] = None,
        params=None,
        batch_sizes: Sequence[int] = (4, 16, 64),
        *,
        seed: int = 0,
        device="cuda",
        **kwargs,
    ):
        super().__init__(**kwargs)
        # text-only embedding: no image branch
        self.config = dataclasses.replace(config or LayoutLMConfig.base(), use_image=False)
        self.tokenizer = HashWordTokenizer(self.config.vocab_size)
        self.batch_sizes = tuple(batch_sizes)
        self.device = resolve_device(device)
        if params is None:
            params = init_flax_layout(self.config, seed, "encoder")
        self.model = load_model(self.config, params, self.device, head="encoder")

    def _encode(self, texts: Sequence[str]):
        """(tokens [bs, L], boxes [bs, L, 4], seq_len [bs]) on the device,
        ``bs`` the padded batch: a text's first ``max_seq_len`` words, an
        empty text as one empty word, boxes all zero."""
        l = self.config.max_seq_len
        bs = pad_batch(len(texts), self.batch_sizes)
        tokens = np.zeros((bs, l), np.int32)
        seq_len = np.ones((bs,), np.int32)
        for i, text in enumerate(texts):
            words = text.split()[:l] or [""]
            for j, wd in enumerate(words):
                tokens[i, j] = self.tokenizer.token_id(wd)
            seq_len[i] = len(words)
        dev = self.device
        return (torch.from_numpy(tokens).to(dev), torch.zeros((bs, l, 4), dtype=torch.int32,
                                                              device=dev),
                torch.from_numpy(seq_len).to(dev))

    @torch.no_grad()
    def get_embeddings(self, texts: Sequence[str], **kwargs) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.config.hidden_dim), np.float32)
        tokens, boxes, seq_len = self._encode(texts)
        with record_function("marie.embeddings"), launch_path("embeddings"), \
                float32_precision(False):
            states = self.model(tokens, boxes, seq_len)[:len(texts)]
            n = seq_len[:len(texts)]
            mask = (torch.arange(states.shape[1], device=states.device)[None, :]
                    < n[:, None])[..., None]
            pooled = (states * mask).sum(1) / n[:, None].to(states.dtype)
            norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
            return (pooled / torch.clamp(norm, min=1e-8)).cpu().numpy()
