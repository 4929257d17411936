"""``gluon.data``, from ``tpu_mx/gluon/data``: datasets, samplers, the
``DataLoader`` and the vision datasets and transforms."""
from .dataset import ArrayDataset, Dataset, RecordFileDataset, SimpleDataset
from .sampler import BatchSampler, RandomSampler, Sampler, SequentialSampler
from .dataloader import DataLoader
from . import vision
