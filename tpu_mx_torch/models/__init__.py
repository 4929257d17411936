"""Models of the port: BERT for pretraining (:mod:`.bert`)."""
from . import bert
from .bert import BERTModel, BERTEncoder, MLMLoss, TransformerLayer, \
    bert_base_config

__all__ = ["bert", "BERTModel", "BERTEncoder", "TransformerLayer",
           "MLMLoss", "bert_base_config"]
