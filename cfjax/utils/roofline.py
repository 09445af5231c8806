"""Published peaks of the cards cfjax is measured on, keyed by JAX's
`device_kind`, and the roofline bound they imply.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates
without sparsity, at the card's full 700 W power limit. A card set to a
lower limit cannot hold its top clock under a matrix-heavy load, so a
share of these peaks is reported beside the card's power limit."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,   # FLOP/s, tensor cores
        "tf32": 495e12,   # FLOP/s, tensor cores
        "f32": 67e12,     # FLOP/s, outside the tensor cores
        "hbm": 3.35e12,   # bytes/s
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table of `device_kind`; a card not in the table is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no published peaks for device kind {device_kind!r}; "
                         f"known: {sorted(PEAKS)}") from None


def roofline_seconds(device_kind: str, flops: float, hbm_bytes: float,
                     rate: str = "f32") -> tuple:
    """(least seconds the card could take, the bound that sets it) for
    `flops` at the `rate` peak and `hbm_bytes` of device-memory traffic."""
    p = peaks(device_kind)
    t_flop, t_mem = flops / p[rate], hbm_bytes / p["hbm"]
    return (t_flop, rate) if t_flop >= t_mem else (t_mem, "hbm")
