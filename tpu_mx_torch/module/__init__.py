"""``mx.module`` (``mx.mod``): the symbolic training API (:mod:`.module`)."""
from .module import BaseModule, BucketingModule, Module

__all__ = ["BaseModule", "Module", "BucketingModule"]
