"""Full-sequence LSTM returning the last hidden state: CUDA kernels, their
plain versions and the autograd ``Function`` that joins them.

Port of ``maunet_tpu/ops/pallas/lstm.py``: the inference forward
(``_pallas_forward``), the training forward that stashes every step's state
(``_pallas_forward_stash``) and the backward through time
(``_pallas_backward``), joined as ``lstm_last_hidden``'s custom VJP
(lstm.py:134-163) is, and the oracle ``lstm_last_hidden_scan``.  The kernels
are ``csrc/lstm.cu``; its header says what bounds them on the H100.  The
TPU backward recomputes the gates and sums dW inside its body; on the card
the backward is two launches, the gate terms of every step at once
(:func:`lstm_gate_terms`) and then the reverse recurrence, and dW is a
launch of its own (:func:`lstm_dw`).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from maunet_tpu_torch.ops.kernels import _build

# The forward and the backward's recurrence hold W_hh in registers (4 * KS
# floats a lane, KS = 4 * ceil(H / 16)), which caps H at 96; in shared memory
# they keep only h, or dgates, double-buffered.  The gate terms keep all of
# W_hh in a block's shared memory, which holds it up to the same H.
FWD_MAX_HIDDEN = 96
# dW's kernel: a block computes a 96-unit x 128-column tile of dW over one
# slice of the B*T rows, staged 16 rows (a chunk) at a time; two blocks fit
# on a SM, of which the H100 has 132.
_DW_UNITS = 96
_DW_COLS = 128
_DW_CHUNK = 16
_DW_BLOCKS_PER_SM = 2


def _dw_plan(b: int, t: int, hidden: int) -> dict[str, int]:
    """dW's launch plan: the B*T rows cut into ``slices`` of
    ``rows_per_slice`` (whole chunks), enough that the ``col_tiles`` x
    ``unit_tiles`` x ``slices`` blocks give at least two per SM, and no
    more, since each slice writes a partial tile that the reduce reads."""
    col_tiles = -(-4 * hidden // _DW_COLS)
    unit_tiles = -(-hidden // _DW_UNITS)
    chunks = max(1, -(-b * t // _DW_CHUNK))
    min_slices = -(-_DW_BLOCKS_PER_SM * 132 // (col_tiles * unit_tiles))
    per_slice = max(1, chunks // min_slices)
    return {"slices": -(-chunks // per_slice), "rows_per_slice": per_slice * _DW_CHUNK,
            "col_tiles": col_tiles, "unit_tiles": unit_tiles}


def lstm_last_hidden_scan(x_proj: torch.Tensor, w_hh: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: a Python loop over T, gate order (i, f, g, o),
    each sample's state frozen at t >= its length.  Differentiable through
    torch autograd, so it is also the plain version of the whole LSTM with
    its gradient."""
    return _scan(x_proj, w_hh, lengths, stash=False)[0]


def _scan(x_proj, w_hh, lengths, stash: bool):
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    xp = x_proj.float()
    w = w_hh.float()
    h = torch.zeros((b, hidden), dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    active = (torch.arange(t, device=x_proj.device)[:, None]
              < lengths.to(x_proj.device)[None, :])
    hs, cs = [], []
    for s in range(t):
        gates = xp[:, s] + h @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = active[s][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        if stash:
            hs.append(h)
            cs.append(c)
    if not stash:
        return h, None, None
    empty = x_proj.new_zeros((b, 0, hidden), dtype=torch.float32)
    return (h, torch.stack(hs, 1) if hs else empty,
            torch.stack(cs, 1) if cs else empty)


def lstm_forward_stash_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                             lengths: torch.Tensor):
    """The plain version of E: the scan, returning (h_last (B, H),
    h_all (B, T, H), c_all (B, T, H)), every step's state after the step
    (the frozen state for t >= length)."""
    return _scan(x_proj, w_hh, lengths, stash=True)


def lstm_backward_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                        lengths: torch.Tensor, h_all: torch.Tensor,
                        c_all: torch.Tensor, g: torch.Tensor):
    """The plain version of F and dW: an explicit reverse loop with the
    gates recomputed from the stash, the formulas of
    ``maunet_tpu/ops/pallas/lstm.py:240-279``.  Returns
    (dx_proj (B, T, 4H), dW_hh (H, 4H)), both f32."""
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    dev = x_proj.device
    xp, w = x_proj.float(), w_hh.float()
    zeros = torch.zeros((b, 1, hidden), dtype=torch.float32, device=dev)
    h_prev = torch.cat([zeros, h_all[:, :-1].float()], 1)
    c_prev = torch.cat([zeros, c_all[:, :-1].float()], 1)
    active = (torch.arange(t, device=dev)[:, None] < lengths.to(dev)[None, :])
    dx = torch.zeros((b, t, four_h), dtype=torch.float32, device=dev)
    dw = torch.zeros((hidden, four_h), dtype=torch.float32, device=dev)
    dh = g.float()
    dc = torch.zeros_like(dh)
    for s in range(t - 1, -1, -1):
        hp = h_prev[:, s]
        gates = xp[:, s] + hp @ w
        i_g, f_g = torch.sigmoid(gates[:, :hidden]), torch.sigmoid(gates[:, hidden:2 * hidden])
        g_g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
        o_g = torch.sigmoid(gates[:, 3 * hidden:])
        tc = torch.tanh(c_all[:, s].float())
        do = dh * tc * o_g * (1.0 - o_g)
        dct = dc + dh * o_g * (1.0 - tc * tc)
        di = dct * g_g * i_g * (1.0 - i_g)
        df = dct * c_prev[:, s] * f_g * (1.0 - f_g)
        dg = dct * i_g * (1.0 - g_g * g_g)
        m = active[s][:, None]
        dgates = torch.where(m, torch.cat([di, df, dg, do], 1), 0.0)
        dx[:, s] = dgates
        dw += torch.where(m, hp, 0.0).t() @ dgates
        dh = torch.where(m, dgates @ w.t(), dh)
        dc = torch.where(m, dct * f_g, dc)
    return dx, dw


def lstm_gate_terms_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                          lengths: torch.Tensor, h_all: torch.Tensor,
                          c_all: torch.Tensor) -> torch.Tensor:
    """The plain version of F's first launch: everything of a step that does
    not depend on the carried adjoints.  The gates are recomputed from the
    stash, pre = x_proj + h_{t-1} W_hh (lstm.py:247-248), and with
    tc = tanh(c_t) each step's coefficients are returned as (B, T, 6H) f32,
    ``[g_i, g_f, g_g, g_o, a, f]``: g_i = g i(1-i), g_f = c_{t-1} f(1-f),
    g_g = i(1-g^2), g_o = tc o(1-o), a = o(1-tc^2), and the forget gate f.
    Zero at t >= length."""
    b, t, four_h = x_proj.shape
    dev = x_proj.device
    zeros = torch.zeros((b, 1, four_h // 4), dtype=torch.float32, device=dev)
    h_prev = torch.cat([zeros, h_all.float()], 1)[:, :t]
    c_prev = torch.cat([zeros, c_all.float()], 1)[:, :t]
    gates = x_proj.float() + h_prev @ w_hh.float()
    i_g, f_g, g_g, o_g = gates.chunk(4, dim=-1)
    i_g, f_g, o_g, g_g = (torch.sigmoid(i_g), torch.sigmoid(f_g), torch.sigmoid(o_g),
                          torch.tanh(g_g))
    tc = torch.tanh(c_all.float())
    terms = torch.cat([g_g * i_g * (1.0 - i_g), c_prev * f_g * (1.0 - f_g),
                       i_g * (1.0 - g_g * g_g), tc * o_g * (1.0 - o_g),
                       o_g * (1.0 - tc * tc), f_g], -1)
    active = torch.arange(t, device=dev)[None, :] < lengths.to(dev)[:, None]
    return torch.where(active[..., None], terms, 0.0)


def lstm_backward_recur_plain(terms: torch.Tensor, w_hh: torch.Tensor,
                              lengths: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain version of F's second launch: the reverse loop that forms
    dh, dc, the gate adjoints and dx_proj (B, T, 4H) f32 from
    :func:`lstm_gate_terms_plain`'s terms and the last hidden state's
    gradient ``g`` (B, H).  dct = dc + dh a, d_o = dh g_o,
    d_{i,f,g} = dct g_{i,f,g}, dc = dct f, dh = dgates W_hh^T; steps
    t >= length pass (dh, dc) through and have zero adjoints."""
    b, t, six_h = terms.shape
    dev = terms.device
    w = w_hh.float()
    active = torch.arange(t, device=dev)[:, None] < lengths.to(dev)[None, :]
    dx = torch.zeros((b, t, 4 * (six_h // 6)), dtype=torch.float32, device=dev)
    dh = g.float()
    dc = torch.zeros_like(dh)
    for s in range(t - 1, -1, -1):
        gi, gf, gg, go, a, f = terms[:, s].float().chunk(6, dim=-1)
        dct = dc + dh * a
        m = active[s][:, None]
        dgates = torch.where(m, torch.cat([dct * gi, dct * gf, dct * gg, dh * go], 1), 0.0)
        dx[:, s] = dgates
        dh = torch.where(m, dgates @ w.t(), dh)
        dc = torch.where(m, dct * f, dc)
    return dx


def lstm_dw_plain(h_all: torch.Tensor, dx_proj: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """The plain version of the dW launch: sum over (b, t) of
    h_{t-1}^T dx_proj[b, t] for 1 <= t < length, in f32."""
    b, t, _ = dx_proj.shape
    dev = dx_proj.device
    h_prev = torch.cat([torch.zeros_like(h_all[:, :1]), h_all[:, :-1]], 1).float()
    steps = torch.arange(t, device=dev)[None, :]
    active = (steps >= 1) & (steps < lengths.to(dev)[:, None])
    h_prev = torch.where(active[..., None], h_prev, 0.0)
    return torch.einsum("btk,btj->kj", h_prev, dx_proj.float())


def _check_lstm_args(what: str, x_proj, w_hh, lengths, extra=(),
                     max_hidden: int | None = None):
    """Validation of the CUDA branch: shapes, dtypes, devices, contiguity
    and the range of H the kernel takes (``max_hidden``)."""
    _build.require(x_proj.dim() == 3 and x_proj.shape[2] % 4 == 0, what,
                   f"x_proj must be (B, T, 4H), got {tuple(x_proj.shape)}")
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    _build.require(tuple(w_hh.shape) == (hidden, four_h), what,
                   f"w_hh must be {(hidden, four_h)}, got {tuple(w_hh.shape)}")
    _build.require(tuple(lengths.shape) == (b,), what,
                   f"lengths must be ({b},), got {tuple(lengths.shape)}")
    for name, arr, shape in extra:
        _build.require(tuple(arr.shape) == shape, what,
                       f"{name} must be {shape}, got {tuple(arr.shape)}")
    for name, arr, dtype in (("x_proj", x_proj, torch.float32),
                             ("w_hh", w_hh, torch.float32),
                             ("lengths", lengths, torch.int32),
                             *((n, a, torch.float32) for n, a, _ in extra)):
        _build.require(arr.device == x_proj.device, what, f"{name} on {arr.device}")
        _build.require(arr.dtype == dtype, what, f"{name} must be {dtype}")
        _build.require(arr.is_contiguous(), what, f"{name} must be contiguous")
    if max_hidden is not None:
        _build.require(1 <= hidden <= max_hidden, what,
                       f"hidden size {hidden} is outside 1..{max_hidden}: the kernels "
                       f"hold W_hh in registers, 4 * ceil(H / 16) * 4 floats a lane, "
                       f"or (the gate terms) all of it in one block's shared memory")
    return b, t, hidden


def lstm_forward_stash(x_proj: torch.Tensor, w_hh: torch.Tensor,
                       lengths: torch.Tensor):
    """E: the forward that also returns every step's state, (h_last (B, H),
    h_all (B, T, H), c_all (B, T, H)) f32.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    what = "lstm_forward_stash"
    if _build.on_cpu(x_proj, what):
        return lstm_forward_stash_plain(x_proj, w_hh, lengths)
    b, t, hidden = _check_lstm_args(what, x_proj, w_hh, lengths,
                                    max_hidden=FWD_MAX_HIDDEN)
    dev = x_proj.device
    out = torch.empty((b, hidden), dtype=torch.float32, device=dev)
    h_all = torch.empty((b, t, hidden), dtype=torch.float32, device=dev)
    c_all = torch.empty_like(h_all)
    _build.launch(what, "maunet_lstm_forward_stash",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p], x_proj,
                  x_proj.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  h_all.data_ptr(), c_all.data_ptr(), b, t, hidden)
    lstm_forward_stash.launches += 1
    return out, h_all, c_all


def _gate_terms_launch(x_proj: torch.Tensor, w_hh: torch.Tensor,
                       lengths: torch.Tensor, h_all: torch.Tensor,
                       c_all: torch.Tensor) -> torch.Tensor:
    """F's first launch on checked CUDA tensors: the gate terms into scratch."""
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    terms = torch.empty((b, t, 6 * hidden), dtype=torch.float32, device=x_proj.device)
    _build.launch("lstm_gate_terms", "maunet_lstm_gate_terms",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p], x_proj,
                  x_proj.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), h_all.data_ptr(),
                  c_all.data_ptr(), terms.data_ptr(), b, t, hidden)
    lstm_gate_terms.launches += 1
    return terms


def lstm_gate_terms(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    lengths: torch.Tensor, h_all: torch.Tensor,
                    c_all: torch.Tensor) -> torch.Tensor:
    """F's first launch: the gate terms (B, T, 6H) f32 of
    :func:`lstm_gate_terms_plain` for every step at once.  A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel, which takes
    1 <= H <= 96 (W_hh whole in a block's shared memory) and leaves the rows
    t >= length unwritten (the recurrence never reads them)."""
    what = "lstm_gate_terms"
    if _build.on_cpu(x_proj, what):
        return lstm_gate_terms_plain(x_proj, w_hh, lengths, h_all, c_all)
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    _check_lstm_args(what, x_proj, w_hh, lengths,
                     extra=(("h_all", h_all, (b, t, hidden)),
                            ("c_all", c_all, (b, t, hidden))),
                     max_hidden=FWD_MAX_HIDDEN)
    return _gate_terms_launch(x_proj, w_hh, lengths, h_all, c_all)


def _backward_recur(terms: torch.Tensor, w_hh: torch.Tensor,
                    lengths: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """F's second launch on checked CUDA tensors: dx_proj from the terms."""
    b, t, six_h = terms.shape
    hidden = six_h // 6
    dx = torch.empty((b, t, 4 * hidden), dtype=torch.float32, device=terms.device)
    _build.launch("lstm_backward", "maunet_lstm_backward",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p], terms,
                  terms.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), g.data_ptr(),
                  dx.data_ptr(), b, t, hidden)
    lstm_backward.launches += 1
    return dx


def lstm_backward(x_proj: torch.Tensor, w_hh: torch.Tensor,
                  lengths: torch.Tensor, h_all: torch.Tensor,
                  c_all: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """F: dx_proj (B, T, 4H) f32 from the forward's stash and the last hidden
    state's gradient ``g`` (B, H); zero at t >= length.  A CPU tensor takes
    the plain version; a CUDA tensor launches two kernels in turn, the gate
    terms into scratch (counted as :func:`lstm_gate_terms`' launches), then
    the reverse recurrence (counted here), which takes 1 <= H <= 96.  dW_hh
    is :func:`lstm_dw` of the result."""
    what = "lstm_backward"
    if _build.on_cpu(x_proj, what):
        return lstm_backward_plain(x_proj, w_hh, lengths, h_all, c_all, g)[0]
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    _check_lstm_args(
        what, x_proj, w_hh, lengths,
        extra=(("h_all", h_all, (b, t, hidden)), ("c_all", c_all, (b, t, hidden)),
               ("g", g, (b, hidden))),
        max_hidden=FWD_MAX_HIDDEN)
    return _backward_recur(_gate_terms_launch(x_proj, w_hh, lengths, h_all, c_all),
                           w_hh, lengths, g)


def lstm_dw(h_all: torch.Tensor, dx_proj: torch.Tensor,
            lengths: torch.Tensor) -> torch.Tensor:
    """dW_hh (H, 4H) f32 = sum over (b, t) of h_{t-1}^T dx_proj[b, t], the
    reduction the TPU backward keeps in its body.  A CPU tensor takes the
    plain version; a CUDA tensor launches the split-row product
    (:func:`_dw_plan`) and its in-order reduce (no atomics: repeated runs
    give the same bits)."""
    what = "lstm_dw"
    if _build.on_cpu(dx_proj, what):
        return lstm_dw_plain(h_all, dx_proj, lengths)
    _build.require(dx_proj.dim() == 3 and dx_proj.shape[2] % 4 == 0, what,
                   f"dx_proj must be (B, T, 4H), got {tuple(dx_proj.shape)}")
    b, t, four_h = dx_proj.shape
    hidden = four_h // 4
    for name, arr, shape, dtype in (("h_all", h_all, (b, t, hidden), torch.float32),
                                    ("dx_proj", dx_proj, (b, t, four_h), torch.float32),
                                    ("lengths", lengths, (b,), torch.int32)):
        _build.require(tuple(arr.shape) == shape, what,
                       f"{name} must be {shape}, got {tuple(arr.shape)}")
        _build.require(arr.device == dx_proj.device and arr.dtype == dtype, what,
                       f"{name} must be {dtype} on {dx_proj.device}")
        _build.require(arr.is_contiguous(), what, f"{name} must be contiguous")
    _build.require(b * t * four_h < 1 << 31, what, "2^31 or more elements in dx_proj")
    plan = _dw_plan(b, t, hidden)
    partial = torch.empty((plan["slices"], hidden, four_h), dtype=torch.float32,
                          device=dx_proj.device)
    dw = torch.empty((hidden, four_h), dtype=torch.float32, device=dx_proj.device)
    _build.launch(what, "maunet_lstm_dw",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p], dx_proj,
                  h_all.data_ptr(), dx_proj.data_ptr(), lengths.data_ptr(), partial.data_ptr(),
                  dw.data_ptr(), b, t, hidden, plan["slices"], plan["rows_per_slice"])
    lstm_dw.launches += 1
    return dw


class _StashedLSTM(torch.autograd.Function):
    """``lstm_last_hidden``'s custom VJP (``maunet_tpu/ops/pallas/lstm.py``
    ``_vjp_fwd``/``_vjp_bwd``): the forward runs E and keeps its stash, the
    backward runs F (two launches) and dW."""

    @staticmethod
    def forward(ctx, x_proj, w_hh, lengths):
        h_last, h_all, c_all = lstm_forward_stash(x_proj, w_hh, lengths)
        ctx.save_for_backward(x_proj, w_hh, lengths, h_all, c_all)
        return h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x_proj, w_hh, lengths, h_all, c_all = ctx.saved_tensors
        dx = lstm_backward(x_proj, w_hh, lengths, h_all, c_all,
                           g.float().contiguous())
        return dx, lstm_dw(h_all, dx, lengths), None


def lstm_last_hidden(x_proj: torch.Tensor, w_hh: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, 4H) f32 pre-projected inputs (x.W_ih + b_ih + b_hh), W_hh
    (H, 4H) f32 and (B,) int32 lengths -> (B, H) f32 last hidden state.

    With grad enabled and an input that needs a gradient, this is the
    autograd ``Function`` over E, F and dW.  Otherwise a CPU tensor takes the
    plain scan and a CUDA tensor launches B, the inference kernel, which the
    ``launches`` count of this function counts."""
    if torch.is_grad_enabled() and (x_proj.requires_grad or w_hh.requires_grad):
        return _StashedLSTM.apply(x_proj, w_hh, lengths)
    what = "lstm_last_hidden"
    if _build.on_cpu(x_proj, what):
        return lstm_last_hidden_scan(x_proj, w_hh, lengths)
    b, t, hidden = _check_lstm_args(what, x_proj, w_hh, lengths,
                                    max_hidden=FWD_MAX_HIDDEN)
    out = torch.empty((b, hidden), dtype=torch.float32, device=x_proj.device)
    _build.launch(what, "maunet_lstm_last_hidden",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p], x_proj,
                  x_proj.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                  b, t, hidden)
    lstm_last_hidden.launches += 1
    return out


lstm_last_hidden.launches = 0
lstm_forward_stash.launches = 0
lstm_gate_terms.launches = 0
lstm_backward.launches = 0
lstm_dw.launches = 0
