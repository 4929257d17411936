"""Models of the port: BERT for pretraining (:mod:`.bert`), the PTB
word-level language model (:mod:`.lstm_lm`), the SSD detector
(:mod:`.ssd`) and LeNet for MNIST (:mod:`.lenet`)."""
from . import bert, lenet, lstm_lm, ssd
from .bert import BERTModel, BERTEncoder, MLMLoss, TransformerLayer, \
    bert_base_config
from .lstm_lm import RNNModel
from .ssd import SSD, SSDTrainingTargets, ssd_300, ssd_512

__all__ = ["bert", "lenet", "lstm_lm", "ssd", "BERTModel", "BERTEncoder",
           "TransformerLayer", "MLMLoss", "bert_base_config", "RNNModel",
           "SSD", "SSDTrainingTargets", "ssd_300", "ssd_512"]
