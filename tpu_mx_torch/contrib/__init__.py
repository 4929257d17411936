"""Contributed planes of the port: :mod:`.chaos` (fault injection)."""
