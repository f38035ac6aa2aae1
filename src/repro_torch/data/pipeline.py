"""Deterministic, sharded, restart-safe token pipeline.

Every batch is a pure function of (seed, step, shard): counter mode, each
batch drawn from its own ``torch.Generator`` seeded from the triple, so
restart-from-checkpoint resumes the exact stream with no iterator state to
persist, and each data-parallel shard generates only its slice.  Synthetic
"language" is the reference's: Zipf-distributed token draws with a Markov
copy pass (p = 0.5 copy the previous token) so the loss signal is
learnable.  The draws come from torch's generator, not ``jax.random``'s
threefry stream, so the two packages' batches differ (as ``DenseLM.init_``
differs from the reference's init); a parity test feeds both the same
batch.  Batches are made on the host.  The vlm and audio stubs
(``patches`` of (b, vision_tokens, vision_dim), ``frames`` of (b,
audio_frames, audio_dim), float32 standard normal) are drawn from the same
generator after the tokens: the reference's distribution, not its numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0
    # modality stubs
    vision_tokens: int = 0
    vision_dim: int = 0
    audio_frames: int = 0
    audio_dim: int = 0

    @property
    def shard_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(f"global_batch {self.global_batch} is not a multiple of n_shards {self.n_shards}")
        return self.global_batch // self.n_shards

    def batch_at(self, step: int) -> Dict[str, Any]:
        # the batch's own generator, seeded from (seed, step, shard)
        words = np.random.SeedSequence([self.seed, step, self.shard]).generate_state(2, np.uint32)
        gen = torch.Generator().manual_seed((int(words[0]) << 31) ^ int(words[1]))
        f = torch.rand((self.shard_batch, self.seq_len), generator=gen)
        # Zipf-ish marginal via exponential transform of uniforms in [1e-6, 1)
        u = f * (1.0 - 1e-6) + 1e-6
        ranks = torch.floor(torch.exp(float(np.log(float(self.vocab))) * u)) - 1
        tokens = ranks.to(torch.int32) % self.vocab
        # Markov smoothing: with p=0.5 copy previous token (learnable bigrams).
        # The reference draws this coin from the ranks' own key, so it is the
        # same uniform: a token is kept exactly when its draw is below 0.5
        # (a rank below sqrt(vocab)), and the rest copy their predecessor.
        keep = f < 0.5
        tokens = torch.where(keep, tokens, torch.roll(tokens, 1, dims=1))
        out: Dict[str, Any] = {"tokens": tokens}
        if self.vision_tokens:
            out["patches"] = torch.randn((self.shard_batch, self.vision_tokens, self.vision_dim), generator=gen)
        if self.audio_frames:
            out["frames"] = torch.randn((self.shard_batch, self.audio_frames, self.audio_dim), generator=gen)
        return out


def pipeline_for(cfg, seq_len: int, global_batch: int, seed: int = 0, n_shards: int = 1,
                 shard: int = 0) -> TokenPipeline:
    """The pipeline of ``cfg``'s family; a vlm's ``seq_len`` counts its
    patches, so its batches carry ``seq_len - vision_tokens`` tokens, and a
    ``seq_len`` that leaves no token (``<= vision_tokens``) raises
    ``ValueError`` (the reference's pipeline would train on an empty token
    row, a NaN loss)."""
    kw = dict(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch, seed=seed, n_shards=n_shards,
              shard=shard)
    if cfg.family == "vlm":
        if seq_len <= cfg.vision_tokens:
            raise ValueError(
                f"a vlm's seq_len counts its {cfg.vision_tokens} vision positions: seq_len {seq_len} leaves "
                f"no token to train on; pass seq_len > vision_tokens ({cfg.vision_tokens})")
        kw.update(vision_tokens=cfg.vision_tokens, vision_dim=cfg.vision_dim, seq_len=seq_len - cfg.vision_tokens)
    if cfg.family == "audio":
        kw.update(audio_frames=cfg.encoder_seq, audio_dim=cfg.d_model)
    return TokenPipeline(**kw)
