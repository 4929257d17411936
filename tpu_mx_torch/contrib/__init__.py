"""Contributed planes of the port: :mod:`.chaos` (fault injection) and
:mod:`.compression` (the gradient quantizers)."""
