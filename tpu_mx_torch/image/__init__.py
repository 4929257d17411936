"""``mx.image``, from ``tpu_mx/image``: decode, resize and crop, the
augmenters, ``ImageIter`` and the detection iterator (:mod:`.image`,
:mod:`.detection`)."""
from .image import *  # noqa: F401,F403
from .detection import (CreateDetAugmenter, DetAugmenter, DetBorrowAug,
                        DetHorizontalFlipAug, DetForceResizeAug,
                        DetRandomCropAug, ImageDetIter)
