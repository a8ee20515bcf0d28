"""MSA masked-language-model self-supervision (counterpart of
`alphafold2_tpu/model/mlm.py`).

Proportional subset masking per MSA row, the mask/random-replace split
with excluded token ids, and a cross-entropy over the replaced positions
only, as a masked mean (static shapes, no boolean indexing).

Noise draws from an explicit `torch.Generator`. Draws are made on the
generator's device and moved to the data's, so one seeded CPU generator
noises a batch the same way on any device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.model.primitives import Dense, random_uniform


def get_mask_subset_with_prob(mask: torch.Tensor, prob: float,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """Sample ~prob fraction of the True positions of each row.
    mask: (b, n) bool -> (b, n) bool subset.

    Takes the top-`ceil(prob*n)` random valid positions, then trims rows
    with fewer valid tokens so each row keeps ~prob * (its valid count).
    The trim compares the running count of valid positions at each rank
    (the reference's rule), so a row with fewer valid positions than
    `ceil(prob*n)` can keep ranks past them: the lowest-index invalid
    positions. The JAX package does the same."""
    batch, seq_len = mask.shape
    max_masked = math.ceil(prob * seq_len)

    num_tokens = mask.sum(-1, keepdim=True)
    # fp32, as the JAX package computes the per-row budget
    budget = torch.ceil(num_tokens.float() * torch.tensor(
        prob, dtype=torch.float32))
    mask_excess = torch.cumsum(mask, dim=-1) > budget
    mask_excess = mask_excess[:, :max_masked]

    rand = random_uniform(mask.shape, generator, mask).masked_fill(
        ~mask, -1e9)
    # top-k with ties (the -1e9 of invalid positions) broken towards the
    # lower index, as lax.top_k breaks them
    sampled = torch.sort(rand, dim=-1, descending=True,
                         stable=True).indices[:, :max_masked]
    sampled = torch.where(mask_excess, 0, sampled + 1)

    new_mask = torch.zeros(batch, seq_len + 1, dtype=torch.bool,
                           device=mask.device)
    new_mask.scatter_(-1, sampled, True)
    return new_mask[:, 1:]


class MLM(nn.Module):
    """MSA-MLM head and noising."""

    def __init__(self, dim: int, num_tokens: int, mask_id: int,
                 mask_prob: float = 0.15,
                 random_replace_token_prob: float = 0.1,
                 keep_token_same_prob: float = 0.1,
                 exclude_token_ids: tuple = (0,)):
        super().__init__()
        self.num_tokens = num_tokens
        self.mask_id = mask_id
        self.mask_prob = mask_prob
        self.random_replace_token_prob = random_replace_token_prob
        self.keep_token_same_prob = keep_token_same_prob
        self.exclude_token_ids = tuple(exclude_token_ids)
        self.to_logits = Dense(dim, num_tokens)

    def noise(self, seq: torch.Tensor, mask: torch.Tensor,
              generator: Optional[torch.Generator] = None):
        """BERT-style noising. seq: (b, m, n) int tokens; mask: (b, m, n).
        Returns (noised_seq, replaced_mask), both (b, m, n)."""
        b, num_msa, n = seq.shape
        seq_f = seq.reshape(b * num_msa, n)
        mask_f = mask.reshape(b * num_msa, n).bool()

        excluded = mask_f
        for token_id in self.exclude_token_ids:
            excluded = excluded & (seq_f != token_id)

        mlm_mask = get_mask_subset_with_prob(excluded, self.mask_prob,
                                             generator)
        noised = torch.where(mlm_mask, self.mask_id, seq_f)

        random_replace_mask = get_mask_subset_with_prob(
            mlm_mask,
            (1.0 - self.keep_token_same_prob)
            * self.random_replace_token_prob, generator)
        random_tokens = torch.randint(
            1, constants.NUM_AMINO_ACIDS, seq_f.shape, generator=generator,
            device=seq_f.device if generator is None
            else generator.device).to(seq_f.device)
        for token_id in self.exclude_token_ids:
            random_replace_mask = random_replace_mask & \
                (random_tokens != token_id)

        noised = torch.where(random_replace_mask, random_tokens.to(
            seq_f.dtype), noised)
        return noised.reshape(b, num_msa, n), mlm_mask.reshape(b, num_msa, n)

    def forward(self, seq_embed: torch.Tensor, original_seq: torch.Tensor,
                replaced_mask: torch.Tensor) -> torch.Tensor:
        """CE loss over the replaced positions. seq_embed: (b, m, n, d);
        original_seq, replaced_mask: (b, m, n)."""
        logits = self.to_logits(seq_embed.float())
        logp = F.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, original_seq.long()[..., None])[..., 0]
        m = replaced_mask.to(logp.dtype)
        return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)
