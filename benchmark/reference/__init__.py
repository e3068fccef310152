"""The plain reference of the ``fine_tune`` training step, frozen.

A copy of the program's plain path, in plain PyTorch and float32: the seven
networks (``model.py`` and the modules it builds), geometry, the plain warp
and photometric functions in place of the four CUDA kernels (``image.py``),
view synthesis, every loss term with the RANSAC ground plane
(``losses.py``, ``ground_plane.py``), and Adam (``step.py``). It imports
nothing of the program: later changes to the program leave it as it is, so
it stays the yardstick that ``benchmark/check.py`` holds the program to.
Module and parameter names are the program's, so one state dict loads into
both.
"""
