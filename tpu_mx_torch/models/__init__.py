"""Models of the port: BERT for pretraining (:mod:`.bert`) and the PTB
word-level language model (:mod:`.lstm_lm`)."""
from . import bert, lstm_lm
from .bert import BERTModel, BERTEncoder, MLMLoss, TransformerLayer, \
    bert_base_config
from .lstm_lm import RNNModel

__all__ = ["bert", "lstm_lm", "BERTModel", "BERTEncoder", "TransformerLayer",
           "MLMLoss", "bert_base_config", "RNNModel"]
