"""apex_tpu_torch.RNN, the PyTorch counterpart of the JAX package's
``RNN`` (Apex's ``apex/RNN``): LSTM, GRU, ReLU, Tanh and mLSTM with the
container API (``stackedRNN``, ``bidirectionalRNN``, a persistent hidden
state).  Plain PyTorch, as it is jnp in the JAX package: no kernel."""
from . import cells
from .models import GRU, LSTM, ReLU, Tanh, mLSTM, mLSTMRNNCell, toRNNBackend
from .RNNBackend import RNNCell, bidirectionalRNN, stackedRNN

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "mLSTMRNNCell",
           "RNNCell", "bidirectionalRNN", "stackedRNN", "cells",
           "toRNNBackend"]
