"""RNN containers and the generic RNNCell, the PyTorch counterpart of the
JAX package's ``RNN/RNNBackend.py`` (Apex's ``apex/RNN/RNNBackend.py``).

Each layer runs its whole sequence before the next layer starts
(layer-major, as the JAX package's one ``lax.scan`` a layer), a Python
loop over time steps whose body is two ``torch.matmul``-backed products
and the gate arithmetic.  The final states of each forward are stored on
the cells, detached, and seed the next call's state: successive calls are
truncated-BPTT boundaries, and ``init_hidden`` / ``reset_hidden`` /
``detach_hidden`` / ``init_inference`` keep their meaning.  Input is
``(seq, batch, feature)``.  Cells run on the CUDA card unless
``device="cpu"`` is passed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.dispatch import resolve_device


class RNNCell(nn.Module):
    """Generic recurrent cell: the gate weights and the persistent hidden
    state, the arithmetic in a pure ``cell`` function.

    gate_multiplier: 4 for LSTM-like, 3 for GRU, 1 for vanilla.
    n_hidden_states: 2 for (h, c) cells, 1 for h-only.
    output_size != hidden_size adds a recurrent projection w_ho.
    """

    def __init__(self, gate_multiplier, input_size, hidden_size, cell,
                 n_hidden_states=2, bias=False, output_size=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.gate_multiplier = gate_multiplier
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.cell = cell
        self.bias = bias
        self.output_size = hidden_size if output_size is None else output_size
        self.gate_size = gate_multiplier * self.hidden_size
        self.n_hidden_states = n_hidden_states
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.w_ih = nn.Parameter(torch.zeros(self.gate_size, input_size,
                                             **kw))
        self.w_hh = nn.Parameter(torch.zeros(self.gate_size,
                                             self.output_size, **kw))
        if self.output_size != self.hidden_size:
            self.w_ho = nn.Parameter(torch.zeros(self.output_size,
                                                 self.hidden_size, **kw))
        self.b_ih = self.b_hh = None
        if bias:
            self.b_ih = nn.Parameter(torch.zeros(self.gate_size, **kw))
            self.b_hh = nn.Parameter(torch.zeros(self.gate_size, **kw))
        self.hidden = [None] * n_hidden_states
        self.reset_parameters()

    def _factory(self):
        return dict(device=self.w_ih.device, dtype=self.w_ih.dtype)

    def new_like(self, new_input_size=None):
        if new_input_size is None:
            new_input_size = self.input_size
        return type(self)(self.gate_multiplier, new_input_size,
                          self.hidden_size, self.cell, self.n_hidden_states,
                          self.bias, self.output_size, **self._factory())

    def reset_parameters(self, gain=1):
        stdev = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-stdev, stdev)

    # -- persistent hidden state ------------------------------------------
    def _state_size(self, i):
        # state 0 is the (possibly projected) output, others cell-internal
        return self.output_size if i == 0 else self.hidden_size

    def init_hidden(self, bsz):
        for i, h in enumerate(self.hidden):
            if h is None or h.shape[0] != bsz:
                self.hidden[i] = torch.zeros((bsz, self._state_size(i)),
                                             **self._factory())

    def reset_hidden(self, bsz):
        self.hidden = [None] * self.n_hidden_states
        self.init_hidden(bsz)

    def detach_hidden(self):
        if any(h is None for h in self.hidden):
            raise RuntimeError("Must initialize hidden state before you can "
                               "detach it")
        self.hidden = [h.detach() for h in self.hidden]

    def init_inference(self, bsz):
        self.init_hidden(bsz)

    # -- arithmetic ----------------------------------------------------------
    def _weights(self):
        return dict(w_ih=self.w_ih, w_hh=self.w_hh, b_ih=self.b_ih,
                    b_hh=self.b_hh)

    def _step(self, w, x, hidden):
        new = list(self.cell(x, hidden, **w))
        if self.output_size != self.hidden_size:
            new[0] = F.linear(new[0], self.w_ho)
        return tuple(new)

    def forward(self, x, *h0):
        """One time step from ``h0`` (the stored state when none is
        given); returns the tuple of new states, which are also stored,
        detached."""
        if not h0:
            self.init_hidden(x.shape[0])
            h0 = tuple(self.hidden)
        new = self._step(self._weights(), x, tuple(h0))
        self.hidden = [h.detach() for h in new]
        return new

    def scan(self, seq, h0, reverse=False):
        """Run ``seq (T, B, F)`` from the states ``h0``: returns
        (all_states, final_states), all_states[i] the (T, B, feat) states
        of hidden state i in the original time order (also when
        ``reverse``)."""
        w = self._weights()
        steps = range(seq.shape[0] - 1, -1, -1) if reverse \
            else range(seq.shape[0])
        h, ys = tuple(h0), [None] * seq.shape[0]
        for t in steps:
            h = self._step(w, seq[t], h)
            ys[t] = h
        return tuple(torch.stack(s) for s in zip(*ys)), h


class stackedRNN(nn.Module):
    """A stack of RNNCells run layer-major over the sequence."""

    def __init__(self, inputRNN, num_layers=1, dropout=0):
        super().__init__()
        self.dropout = dropout
        if isinstance(inputRNN, RNNCell):
            rnns = [inputRNN]
            for _ in range(num_layers - 1):
                rnns.append(inputRNN.new_like(inputRNN.output_size))
        elif isinstance(inputRNN, list):
            if len(inputRNN) != num_layers:
                raise ValueError("RNN list length must be equal to "
                                 "num_layers")
            rnns = inputRNN
        else:
            raise RuntimeError()
        self.nLayers = len(rnns)
        self.rnns = nn.ModuleList(rnns)

    def _flat_hidden(self, bsz):
        self.init_hidden(bsz)
        return [h for cell in self.rnns for h in cell.hidden]

    def forward(self, x, *flat_h0, collect_hidden=False, reverse=False):
        """Returns (output, hiddens).

        output: (T, B, out).  hiddens: a tuple over the hidden states of
        (layer, B, feat) final states, or with ``collect_hidden`` a tuple
        over the hidden states of per-step tuples of (layer, B, feat).
        Without ``flat_h0`` the stored states seed the run; the final
        states are stored, detached."""
        if not flat_h0:
            flat_h0 = self._flat_hidden(x.shape[1])
        all_states, finals = [], []
        out, it = x, iter(flat_h0)
        for cell in self.rnns:
            h0 = tuple(next(it) for _ in range(cell.n_hidden_states))
            ys, final = cell.scan(out, h0, reverse=reverse)
            out = ys[0]
            all_states.append(ys)
            finals.append(final)
        for cell, final in zip(self.rnns, finals):
            cell.hidden = [h.detach() for h in final]
        n_hid = self.rnns[0].n_hidden_states
        if collect_hidden:
            hiddens = tuple(
                tuple(torch.stack([ys[i] for ys in all_states], dim=1)
                      .unbind(0))
                for i in range(n_hid))
        else:
            hiddens = tuple(torch.stack([f[i] for f in finals])
                            for i in range(n_hid))
        return out, hiddens

    def reset_parameters(self):
        for rnn in self.rnns:
            rnn.reset_parameters()

    def init_hidden(self, bsz):
        for rnn in self.rnns:
            rnn.init_hidden(bsz)

    def detach_hidden(self):
        for rnn in self.rnns:
            rnn.detach_hidden()

    def reset_hidden(self, bsz):
        for rnn in self.rnns:
            rnn.reset_hidden(bsz)

    def init_inference(self, bsz):
        for rnn in self.rnns:
            rnn.init_inference(bsz)


class bidirectionalRNN(nn.Module):
    """A forward and a time-reversed stackedRNN, their outputs and states
    concatenated along the features."""

    def __init__(self, inputRNN, num_layers=1, dropout=0):
        super().__init__()
        self.dropout = dropout
        self.fwd = stackedRNN(inputRNN, num_layers=num_layers,
                              dropout=dropout)
        self.bckwrd = stackedRNN(inputRNN.new_like(), num_layers=num_layers,
                                 dropout=dropout)

    def forward(self, x, *flat_h0, collect_hidden=False):
        bsz = x.shape[1]
        if not flat_h0:
            flat_h0 = (self.fwd._flat_hidden(bsz)
                       + self.bckwrd._flat_hidden(bsz))
        k = len(flat_h0) // 2
        fwd_out, fwd_hiddens = self.fwd(x, *flat_h0[:k],
                                        collect_hidden=collect_hidden)
        bck_out, bck_hiddens = self.bckwrd(x, *flat_h0[k:], reverse=True,
                                           collect_hidden=collect_hidden)
        output = torch.cat([fwd_out, bck_out], dim=-1)
        if collect_hidden:
            hiddens = tuple(
                tuple(torch.cat([f, b], dim=-1) for f, b in zip(fs, bs))
                for fs, bs in zip(fwd_hiddens, bck_hiddens))
        else:
            hiddens = tuple(torch.cat([f, b], dim=-1)
                            for f, b in zip(fwd_hiddens, bck_hiddens))
        return output, hiddens

    def reset_parameters(self):
        for rnn in (self.fwd, self.bckwrd):
            rnn.reset_parameters()

    def init_hidden(self, bsz):
        for rnn in (self.fwd, self.bckwrd):
            rnn.init_hidden(bsz)

    def detach_hidden(self):
        for rnn in (self.fwd, self.bckwrd):
            rnn.detach_hidden()

    def reset_hidden(self, bsz):
        for rnn in (self.fwd, self.bckwrd):
            rnn.reset_hidden(bsz)

    def init_inference(self, bsz):
        for rnn in (self.fwd, self.bckwrd):
            rnn.init_inference(bsz)
