"""Measurement entry points of the port, run on the card:

    python -m generativedensification_torch.tools.kernel_break [stages] [--scene A|B] [--bwd]
    python -m generativedensification_torch.tools.surfel_break [stages] [--scene A|B]
    python -m generativedensification_torch.tools.sass_check --parent DIR

``kernel_break`` / ``surfel_break`` print the stage breakdown of the forward
compositors (kernels ``csrc/composite_fwd.cu`` and ``csrc/surfel_fwd.cu``)
from their stage probes, ``scenes`` builds the seeded scenes they and
``chip_smoke.py`` measure, ``timing`` holds the card's rates, the operation
counts and the CUDA-event timer.
"""
