"""Depth engines: the bit-exact parity pipeline (parity.py) and the dense
fast path (dense.py, sgm.py, pyramid.py, and the refine kernel in
refine_triton.py)."""

from stepth.match import dense, parity, pyramid  # noqa: F401
