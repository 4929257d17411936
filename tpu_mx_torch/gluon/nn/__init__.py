"""Basic layers (:mod:`.basic_layers`) and 2-D convolution and pooling
layers (:mod:`.conv_layers`)."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridSequential, LayerNorm)
from .conv_layers import (AvgPool2D, Conv2D, GlobalAvgPool2D,
                          GlobalMaxPool2D, MaxPool2D)

__all__ = ["Activation", "BatchNorm", "Dense", "Dropout", "Embedding",
           "Flatten",
           "HybridSequential", "LayerNorm", "Conv2D",
           "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D", "GlobalAvgPool2D"]
