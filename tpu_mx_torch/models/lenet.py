"""LeNet-5 for MNIST, from ``tpu_mx/models/lenet.py`` (BASELINE config
0): no input sizes are declared, so every weight is drawn at the first
forward after ``initialize()``."""
from ..gluon import nn

__all__ = ["lenet"]


def lenet(classes=10):
    net = nn.HybridSequential()
    net.add(nn.Conv2D(20, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(50, kernel_size=5, activation="tanh"),
            nn.MaxPool2D(2, 2),
            nn.Flatten(),
            nn.Dense(500, activation="tanh"),
            nn.Dense(classes))
    return net
