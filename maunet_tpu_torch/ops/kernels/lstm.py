"""Full-sequence LSTM returning the last hidden state: CUDA kernel and the
plain scan.

Port of the inference forward of ``maunet_tpu/ops/pallas/lstm.py``
(``_pallas_forward``, reached through ``lstm_last_hidden``) and of its oracle
``lstm_last_hidden_scan``.  The kernel is ``csrc/lstm.cu``; its header says
what bounds it on the H100.  The training kernels (the stash forward and the
backward) are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from maunet_tpu_torch.ops.kernels import _build


def lstm_last_hidden_scan(x_proj: torch.Tensor, w_hh: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """The plain version: a Python loop over T, gate order (i, f, g, o),
    each sample's state frozen at t >= its length."""
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    xp = x_proj.float()
    w = w_hh.float()
    h = torch.zeros((b, hidden), dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    active = (torch.arange(t, device=x_proj.device)[:, None]
              < lengths.to(x_proj.device)[None, :])
    for s in range(t):
        gates = xp[:, s] + h @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = active[s][:, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
    return h


def lstm_last_hidden(x_proj: torch.Tensor, w_hh: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, 4H) f32 pre-projected inputs (x.W_ih + b_ih + b_hh), W_hh
    (H, 4H) f32 and (B,) int32 lengths -> (B, H) f32 last hidden state.  A
    CPU tensor takes the plain scan; a CUDA tensor launches the kernel."""
    what = "lstm_last_hidden"
    if _build.on_cpu(x_proj, what):
        return lstm_last_hidden_scan(x_proj, w_hh, lengths)
    _build.require(x_proj.dim() == 3 and x_proj.shape[2] % 4 == 0, what,
                   f"x_proj must be (B, T, 4H), got {tuple(x_proj.shape)}")
    b, t, four_h = x_proj.shape
    hidden = four_h // 4
    _build.require(tuple(w_hh.shape) == (hidden, four_h), what,
                   f"w_hh must be {(hidden, four_h)}, got {tuple(w_hh.shape)}")
    _build.require(tuple(lengths.shape) == (b,), what,
                   f"lengths must be ({b},), got {tuple(lengths.shape)}")
    for name, arr, dtype in (("x_proj", x_proj, torch.float32),
                             ("w_hh", w_hh, torch.float32),
                             ("lengths", lengths, torch.int32)):
        _build.require(arr.device == x_proj.device, what, f"{name} on {arr.device}")
        _build.require(arr.dtype == dtype, what, f"{name} must be {dtype}")
        _build.require(arr.is_contiguous(), what, f"{name} must be contiguous")
    # 4H threads per block; W_hh must fit the 227 KB shared-memory opt-in.
    _build.require(hidden <= 119, what, f"hidden size {hidden} > 119")
    out = torch.empty((b, hidden), dtype=torch.float32, device=x_proj.device)
    fn = _build.function("maunet_lstm_last_hidden",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
    _build.check(fn(x_proj.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), b, t, hidden, _build.stream_of(x_proj)), what)
    lstm_last_hidden.launches += 1
    return out


lstm_last_hidden.launches = 0
