"""Pretrained-embedding wrappers: ESM-1b, MSA-Transformer, ProtTrans
(counterpart of `alphafold2_tpu/embeds.py`).

A wrapper holds the port's `Alphafold2`; it embeds the sequences (and
the MSA) with a frozen protein language model, slices off the model's
special tokens, and injects the result as `seq_embed` / `msa_embed`,
which the model projects to its width. The language models run on the
host; only their arrays reach the model's device. Every hub or
HuggingFace load is lazy and gated: without the weights (offline, or
the package missing) the first embedding raises RuntimeError, as the
JAX wrappers do. Nothing is downloaded at import or construction.
"""

from __future__ import annotations

import numpy as np
import torch

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.data.featurize import detokenize


class _PretrainedWrapper:
    """Common scaffolding: wraps an `Alphafold2` and injects the
    embeddings. Subclasses define `_load()` and `_embed_tokens()` (or
    `embed_batch()`)."""

    def __init__(self, alphafold2):
        self.alphafold2 = alphafold2
        self._backend = None

    def _ensure_loaded(self):
        if self._backend is None:
            try:
                self._backend = self._load()
            except Exception as exc:
                raise RuntimeError(
                    f"{type(self).__name__} needs its pretrained weights "
                    f"(download failed or package missing): {exc}") from exc
        return self._backend

    def _embed_tokens(self, tokens_2d) -> np.ndarray:
        """(rows, L) int tokens -> (rows, L, lm_dim) embeddings."""
        raise NotImplementedError

    def embed_batch(self, seq, msa=None):
        """(seq_embed, msa_embed) numpy arrays at the LM's width: the
        sequence embedded directly, the MSA row by row (flattened through
        `_embed_tokens`)."""
        seq_embed = self._embed_tokens(_numpy(seq))
        msa_embed = None
        if msa is not None:
            m = _numpy(msa)
            flat = m.reshape(-1, m.shape[-1])
            msa_embed = self._embed_tokens(flat).reshape(*m.shape, -1)
        return seq_embed, msa_embed

    def __call__(self, seq=None, msa=None, **kwargs):
        """The wrapped model's forward with the embeddings injected; the
        sequence, the MSA and the embeddings go to the model's device."""
        seq_embed, msa_embed = self.embed_batch(seq, msa)
        device = self.alphafold2.device

        def put(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), device=device)

        return self.alphafold2(put(seq), msa=put(msa),
                               seq_embed=put(seq_embed),
                               msa_embed=put(msa_embed), **kwargs)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class ESMEmbedWrapper(_PretrainedWrapper):
    """ESM-1b per-token embeddings (layer 33, 1280-d); the leading BOS
    token is dropped."""

    REPR_LAYER = 33

    def _load(self):
        model, alphabet = torch.hub.load(*constants.ESM_MODEL_PATH)
        model.eval()
        return model, alphabet.get_batch_converter()

    def _embed_tokens(self, tokens_2d) -> np.ndarray:
        model, batch_converter = self._ensure_loaded()
        data = [(f"s{i}", detokenize(row).replace("_", "<pad>"))
                for i, row in enumerate(np.asarray(tokens_2d))]
        _, _, toks = batch_converter(data)
        with torch.no_grad():
            out = model(toks, repr_layers=[self.REPR_LAYER],
                        return_contacts=False)
        reps = out["representations"][self.REPR_LAYER]
        return reps[:, 1:1 + tokens_2d.shape[-1]].cpu().numpy()


class MSAEmbedWrapper(_PretrainedWrapper):
    """MSA-Transformer row embeddings (esm_msa1, layer 12, 768-d): the
    whole alignment of each batch item embedded jointly; its first row
    doubles as the sequence embedding."""

    REPR_LAYER = 12

    def _load(self):
        model, alphabet = torch.hub.load(*constants.MSA_MODEL_PATH)
        model.eval()
        return model, alphabet.get_batch_converter()

    def embed_batch(self, seq, msa=None):
        model, batch_converter = self._ensure_loaded()
        assert msa is not None, "MSAEmbedWrapper needs an MSA"
        m = _numpy(msa)
        embeds = []
        for b in range(m.shape[0]):
            data = [(f"r{r}", detokenize(m[b, r]).replace("_", "-"))
                    for r in range(m.shape[1])]
            # the MSA batch converter returns (1, R, L + 1)
            _, _, toks = batch_converter(data)
            with torch.no_grad():
                out = model(toks, repr_layers=[self.REPR_LAYER])
            reps = out["representations"][self.REPR_LAYER]
            embeds.append(reps[0, :, 1:1 + m.shape[-1]].cpu().numpy())
        msa_embed = np.stack(embeds)
        return msa_embed[:, 0], msa_embed


class ProtT5EmbedWrapper(_PretrainedWrapper):
    """ProtT5-XL-U50 embeddings through HuggingFace (1024-d). There is no
    leading CLS token: only the trailing ``</s>`` is dropped."""

    def _load(self):
        from transformers import T5EncoderModel, T5Tokenizer
        name = "Rostlab/prot_t5_xl_uniref50"
        return (T5EncoderModel.from_pretrained(name),
                T5Tokenizer.from_pretrained(name, do_lower_case=False))

    def _embed_tokens(self, tokens_2d) -> np.ndarray:
        model, tokenizer = self._ensure_loaded()
        texts = [" ".join(detokenize(row).replace("_", "X"))
                 for row in np.asarray(tokens_2d)]
        enc = tokenizer.batch_encode_plus(texts, add_special_tokens=True,
                                          padding=True, return_tensors="pt")
        with torch.no_grad():
            out = model(input_ids=enc["input_ids"],
                        attention_mask=enc["attention_mask"])
        reps = out.last_hidden_state
        return reps[:, :tokens_2d.shape[-1]].float().cpu().numpy()


class ProtTranEmbedWrapper(_PretrainedWrapper):
    """ProtBERT embeddings through HuggingFace (1024-d); the leading CLS
    token is dropped."""

    def _load(self):
        from transformers import AutoModel, AutoTokenizer
        name = "Rostlab/prot_bert"
        return (AutoModel.from_pretrained(name),
                AutoTokenizer.from_pretrained(name))

    def _embed_tokens(self, tokens_2d) -> np.ndarray:
        model, tokenizer = self._ensure_loaded()
        texts = [" ".join(detokenize(row).replace("_", "X"))
                 for row in np.asarray(tokens_2d)]
        enc = tokenizer(texts, return_tensors="pt", padding=True)
        with torch.no_grad():
            out = model(**enc).last_hidden_state
        return out[:, 1:1 + tokens_2d.shape[-1]].cpu().numpy()
