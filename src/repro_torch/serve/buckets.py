"""Shape-bucket policy for the serving tier.

Counterpart of ``repro.serve.buckets``; the grid is read from
``LILAC_TORCH_SERVE_BUCKETS``, the port's own name, so that one package's
setting never reaches the other.

Every distinct ``(batch, cache capacity)`` pair is a distinct decode
signature — a separate trace, detection pass and baked
:class:`~repro_torch.core.plan.ExecutablePlan`.  Continuous batching changes the
active batch every step, so unbucketed shapes would re-compile on nearly
every admit/evict.  The bucket policy quantizes both axes to a small grid:

* **batch buckets** — the decode batch is padded up to the smallest bucket
  that holds the active request count (inactive rows compute garbage that
  is never read back);
* **sequence buckets** — the KV-cache capacity is padded up to the
  smallest bucket that holds ``prompt_len + max_new_tokens`` of the
  longest active request.

The grid is exactly what :meth:`repro_torch.serve.Engine.prewarm` bakes plans
for at startup, so a steady-state decode step never pays detect / tune /
bake on the request path.

``LILAC_TORCH_SERVE_BUCKETS`` overrides the default grid with
``"<batch,...>x<seq,...>"``, e.g.
``LILAC_TORCH_SERVE_BUCKETS=1,2,4x128,512``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple

_ENV_BUCKETS = "LILAC_TORCH_SERVE_BUCKETS"

DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8)
DEFAULT_SEQ_BUCKETS: Tuple[int, ...] = (128, 256, 512, 1024)


class BucketError(ValueError):
    """Malformed bucket spec, or a request that exceeds every bucket."""


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """A sorted grid of batch and sequence-capacity buckets."""
    batch: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS
    seq: Tuple[int, ...] = DEFAULT_SEQ_BUCKETS

    def __post_init__(self):
        for name, vals in (("batch", self.batch), ("seq", self.seq)):
            if not vals or any(int(v) <= 0 for v in vals):
                raise BucketError(f"{name} buckets must be positive: {vals}")
        object.__setattr__(self, "batch", tuple(sorted(set(self.batch))))
        object.__setattr__(self, "seq", tuple(sorted(set(self.seq))))

    @property
    def max_batch(self) -> int:
        return self.batch[-1]

    @property
    def max_seq(self) -> int:
        return self.seq[-1]

    def batch_bucket(self, n: int) -> int:
        """Smallest batch bucket holding ``n`` active requests."""
        for b in self.batch:
            if n <= b:
                return b
        raise BucketError(f"{n} active requests exceed the largest batch "
                          f"bucket {self.max_batch}")

    def seq_bucket(self, n: int) -> int:
        """Smallest sequence bucket with capacity for ``n`` positions."""
        for s in self.seq:
            if n <= s:
                return s
        raise BucketError(f"sequence length {n} exceeds the largest "
                          f"sequence bucket {self.max_seq}")

    def grid(self) -> Tuple[Tuple[int, int], ...]:
        """Every (batch, seq) pair — the prewarm set."""
        return tuple((b, s) for b in self.batch for s in self.seq)

    def spec(self) -> str:
        """Round-trippable ``LILAC_TORCH_SERVE_BUCKETS`` form."""
        return (",".join(str(b) for b in self.batch) + "x"
                + ",".join(str(s) for s in self.seq))


def parse_buckets(spec: str) -> BucketPolicy:
    """Parse ``"1,2,4x128,256"`` into a :class:`BucketPolicy`."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise BucketError(
            f"bucket spec must be '<batch,...>x<seq,...>', got {spec!r}")
    try:
        batch = tuple(int(v) for v in parts[0].split(",") if v.strip())
        seq = tuple(int(v) for v in parts[1].split(",") if v.strip())
    except ValueError as e:
        raise BucketError(f"bucket spec {spec!r}: {e}") from None
    return BucketPolicy(batch=batch, seq=seq)


def default_buckets() -> BucketPolicy:
    """The env-resolved policy (``LILAC_TORCH_SERVE_BUCKETS`` or the
    default)."""
    spec = os.environ.get(_ENV_BUCKETS)
    if spec:
        return parse_buckets(spec)
    return BucketPolicy()
