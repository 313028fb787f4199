"""Cell functions, the PyTorch counterpart of the JAX package's
``RNN/cells.py``.

Each is ``cell(x, hidden, w_ih, w_hh, ..., b_ih=None, b_hh=None) ->
tuple(new hidden states)`` for one time step.  The gate layouts are
torch's (LSTM: i, f, g, o; GRU: r, z, n), so weights are interchangeable
with torch checkpoints.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gates(x, h, w_ih, w_hh, b_ih, b_hh):
    return F.linear(x, w_ih, b_ih) + F.linear(h, w_hh, b_hh)


def _lstm_tail(gates, cx):
    i, f, g, o = gates.chunk(4, dim=-1)
    cy = torch.sigmoid(f) * cx + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(cy), cy


def lstm_cell(x, hidden, w_ih, w_hh, b_ih=None, b_hh=None):
    """torch LSTMCell math; returns (hy, cy)."""
    hx, cx = hidden
    return _lstm_tail(_gates(x, hx, w_ih, w_hh, b_ih, b_hh), cx)


def gru_cell(x, hidden, w_ih, w_hh, b_ih=None, b_hh=None):
    """torch GRUCell math; returns (hy,)."""
    (hx,) = hidden
    i_r, i_z, i_n = F.linear(x, w_ih, b_ih).chunk(3, dim=-1)
    h_r, h_z, h_n = F.linear(hx, w_hh, b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (n + z * (hx - n),)


def rnn_relu_cell(x, hidden, w_ih, w_hh, b_ih=None, b_hh=None):
    (hx,) = hidden
    return (torch.relu(_gates(x, hx, w_ih, w_hh, b_ih, b_hh)),)


def rnn_tanh_cell(x, hidden, w_ih, w_hh, b_ih=None, b_hh=None):
    (hx,) = hidden
    return (torch.tanh(_gates(x, hx, w_ih, w_hh, b_ih, b_hh)),)


def mlstm_cell(x, hidden, w_ih, w_hh, w_mih, w_mhh, b_ih=None, b_hh=None):
    """Multiplicative LSTM: the intermediate state m = (W_mih x) * (W_mhh
    h) replaces h in the recurrent gate product.  Returns (hy, cy)."""
    hx, cx = hidden
    m = F.linear(x, w_mih) * F.linear(hx, w_mhh)
    return _lstm_tail(F.linear(x, w_ih, b_ih) + F.linear(m, w_hh, b_hh), cx)
