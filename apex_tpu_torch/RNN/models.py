"""RNN factories and the mLSTM cell module, the PyTorch counterpart of the
JAX package's ``RNN/models.py``.

Each factory returns a stackedRNN (or a bidirectionalRNN) over cells on
``device`` (the CUDA card unless ``device="cpu"``).  Input is (seq, batch,
feature); ``batch_first`` and ``dropout`` are taken for the signature and,
as in the JAX package and Apex, not applied by the containers.
"""
from __future__ import annotations

import torch
from torch import nn

from . import cells
from .RNNBackend import RNNCell, bidirectionalRNN, stackedRNN


class mLSTMRNNCell(RNNCell):
    """Multiplicative-LSTM cell: the LSTM weights plus the m-state
    projections w_mih and w_mhh."""

    def __init__(self, input_size, hidden_size, bias=False, output_size=None,
                 device=None, dtype=torch.float32):
        super().__init__(4, input_size, hidden_size, cells.mlstm_cell,
                         n_hidden_states=2, bias=bias,
                         output_size=output_size, device=device, dtype=dtype)
        kw = self._factory()
        self.w_mih = nn.Parameter(torch.zeros(self.output_size,
                                              self.input_size, **kw))
        self.w_mhh = nn.Parameter(torch.zeros(self.output_size,
                                              self.output_size, **kw))
        self.reset_parameters()

    def _weights(self):
        return dict(super()._weights(), w_mih=self.w_mih, w_mhh=self.w_mhh)

    def new_like(self, new_input_size=None):
        if new_input_size is None:
            new_input_size = self.input_size
        return type(self)(new_input_size, self.hidden_size, self.bias,
                          self.output_size, **self._factory())


def toRNNBackend(inputRNN, num_layers, bidirectional=False, dropout=0):
    if bidirectional:
        return bidirectionalRNN(inputRNN, num_layers, dropout=dropout)
    return stackedRNN(inputRNN, num_layers, dropout=dropout)


def _factory(name, gate_multiplier, cell, n_hidden_states):
    """The factory ``name`` of stacks of ``RNNCell(gate_multiplier, ...,
    cell, n_hidden_states)``."""
    def build(input_size, hidden_size, num_layers, bias=True,
              batch_first=False, dropout=0, bidirectional=False,
              output_size=None, device=None, dtype=torch.float32):
        inputRNN = RNNCell(gate_multiplier, input_size, hidden_size, cell,
                           n_hidden_states, bias, output_size, device=device,
                           dtype=dtype)
        return toRNNBackend(inputRNN, num_layers, bidirectional,
                            dropout=dropout)
    build.__name__ = build.__qualname__ = name
    return build


LSTM = _factory("LSTM", 4, cells.lstm_cell, 2)
GRU = _factory("GRU", 3, cells.gru_cell, 1)
ReLU = _factory("ReLU", 1, cells.rnn_relu_cell, 1)
Tanh = _factory("Tanh", 1, cells.rnn_tanh_cell, 1)


def mLSTM(input_size, hidden_size, num_layers, bias=True, batch_first=False,
          dropout=0, bidirectional=False, output_size=None, device=None,
          dtype=torch.float32):
    inputRNN = mLSTMRNNCell(input_size, hidden_size, bias=bias,
                            output_size=output_size, device=device,
                            dtype=dtype)
    return toRNNBackend(inputRNN, num_layers, bidirectional, dropout=dropout)
