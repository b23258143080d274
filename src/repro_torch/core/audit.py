"""Wire-length validation (the length guard of the audit plane), in torch.

Counterpart of `repro.core.audit`'s `WireIntegrityError` and
`check_payload_len`.  The checksums, bound reports and degradation policies
are still to be ported (ROADMAP A9).
"""
from __future__ import annotations

import numpy as np
import torch


class WireIntegrityError(ValueError):
    """A transmitted wire failed a structural or checksum audit."""


def check_payload_len(payload_len, capacity: int, *, what: str = "wire"):
    """A transmitted `payload_len` past the padded plane's capacity raises a
    structured error instead of indexing garbage.  Reading a device tensor
    here costs one small host copy."""
    lens = (payload_len.detach().cpu().numpy() if torch.is_tensor(payload_len)
            else np.asarray(payload_len))
    if lens.size and ((lens < 0).any() or (lens > capacity).any()):
        bad = lens.reshape(-1)
        raise WireIntegrityError(
            f"{what}: transmitted payload_len {bad[:8].tolist()}"
            f"{'...' if bad.size > 8 else ''} outside [0, {capacity}] — "
            f"corrupt or truncated wire")
