"""Operations and bytes, counted from a configuration's shapes.

The published peaks of one NVIDIA H100 (SXM, dense), the model's
mathematics per tile (every 3x3 conv over all its input channels, the
broadcast embeddings included, as the published model concatenates them;
the 1x1 head; the LSTM over the steps its lengths need; the dense layers),
and kernel A's work per launch: each input byte read once and each output
byte written once.  Nothing here looks at which kernels the program
launches, so a count reads the same work whoever implements it.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# Kernel A takes the 3x3 convs of this output width or less in eval mode.
A_MAX_COUT = 64


@dataclass(frozen=True)
class Conv:
    """One 3x3 conv of a forward: its spatial input parts (channels), the
    broadcast embedding channels it also reads, its output width and side."""
    name: str
    parts: tuple[int, ...]
    emb: int
    cout: int
    side: int

    @property
    def cin(self) -> int:
        return sum(self.parts) + self.emb


def convs(cfg: dict, side: int) -> list[Conv]:
    """The 3x3 convs of one forward at ``side`` x ``side``, in order."""
    base = cfg["base_filters"]
    nb = [base * 2 ** i for i in range(5)]
    emb = (cfg["temporal_dim"] if cfg["temporal_embeddings"] else 0) \
        + (cfg["meta_dim"] if cfg["metadata_embeddings"] else 0)
    out: list[Conv] = []

    def block(name, parts, lvl, cout, e=0):
        s = side >> lvl
        out.append(Conv(f"{name}.conv1", tuple(parts), e, cout, s))
        out.append(Conv(f"{name}.conv2", (cout,), 0, cout, s))

    block("conv0_0", [cfg["in_channels"]], 0, nb[0])
    for lvl in range(1, 4):
        block(f"conv{lvl}_0", [nb[lvl - 1]], lvl, nb[lvl])
    if cfg["model_type"] == "unet":
        block("conv4_0", [nb[3]], 4, nb[4], emb)
        for lvl in (3, 2, 1, 0):
            block(f"conv{lvl}_1", [nb[lvl], nb[lvl + 1]], lvl, nb[lvl])
        return out
    block("conv4_0", [nb[3]], 4, nb[4])
    for lvl, j in ((0, 1), (1, 1), (2, 1), (3, 1), (0, 2), (1, 2), (2, 2), (0, 3), (1, 3), (0, 4)):
        block(f"conv{lvl}_{j}", [nb[lvl]] * j + [nb[lvl + 1]], lvl, nb[lvl], emb)
    return out


def forward_flops(cfg: dict, side: int, batch: int, lstm_step_count: int) -> float:
    """Multiply-add operations (2 each) of one forward of ``batch`` tiles."""
    conv = sum(2 * c.side * c.side * 9 * c.cin * c.cout for c in convs(cfg, side))
    head = 2 * side * side * cfg["base_filters"] * cfg["out_channels"]
    h = cfg["lstm_hidden"]
    dense = 0
    if cfg["temporal_embeddings"]:
        dense += 2 * h * cfg["temporal_dim"]
    if cfg["metadata_embeddings"]:
        dense += 2 * (cfg["meta_features"] * 32 + 32 * cfg["meta_dim"])
    lstm = lstm_step_count * 2 * (h + 1) * 4 * h
    return float(batch * (conv + head + dense) + (lstm if cfg["temporal_embeddings"] else 0))


def a_launches(cfg: dict, side: int) -> list[Conv]:
    """The convs kernel A computes in an eval forward."""
    return [c for c in convs(cfg, side) if c.cout <= A_MAX_COUT]


def conv_work(b: int, side: int, parts, cout: int, with_add: bool, kind: str = "bf16"):
    """One fused conv's (bytes, operations): parts and output in ``kind``,
    the f32 weights, scale and bias and the compact embedding add, each
    once; 2 operations a multiply-add."""
    cin = sum(parts)
    nbytes = (b * side * side * (cin + cout) * (2 if kind == "bf16" else 4) + 9 * cin * cout * 4
              + 2 * cout * 4 + (b * 3 * side * cout * 4 if with_add else 0))
    return nbytes, 2 * b * side * side * 9 * cin * cout


def bound_s(nbytes: float, flops: float, kind: str = "bf16") -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def a_bound_s(cfg: dict, side: int, batch: int) -> float:
    """Kernel A's bound summed over the launches of one eval forward."""
    return sum(bound_s(*conv_work(batch, c.side, c.parts, c.cout, c.emb > 0))
               for c in a_launches(cfg, side))
