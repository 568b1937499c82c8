"""Entry points and helpers of the port's tools, run on the card unless a
caller passes ``device="cpu"``:

    python -m generativedensification_torch.tools.eval_all [key=value ...]
    python -m generativedensification_torch.tools.metric_co3d [metrics.json ...]
    python -m generativedensification_torch.tools.convert_torch_ckpt --ckpt F --out DIR
    python -m generativedensification_torch.tools.convert_lpips --net vgg --out F [--random]
    python -m generativedensification_torch.tools.kernel_break [stages] [--scene A|B] [--bwd]
    python -m generativedensification_torch.tools.surfel_break [stages] [--scene A|B]
    python -m generativedensification_torch.tools.sass_check --parent DIR

``eval_all`` / ``metric_co3d`` run and pool the benchmark evaluations;
``convert_torch_ckpt`` turns a reference checkpoint into the port's
checkpoint directory and ``convert_lpips`` writes LPIPS weights;
``video_path`` / ``pose_interp`` build the orbit cameras,
``mesh_extractor`` / ``mesh_render`` the TSDF mesh and its turntable;
``hdf5_tools``, ``prepare_dataset``, ``pose_groups``, ``prepare_co3d`` and
``download`` are the JAX package's data tools, copied.
``kernel_break`` / ``surfel_break`` print the stage breakdown of the forward
compositors (kernels ``csrc/composite_fwd.cu`` and ``csrc/surfel_fwd.cu``)
from their stage probes, ``scenes`` builds the seeded scenes they and
``chip_smoke.py`` measure, ``timing`` holds the card's rates, the operation
counts and the CUDA-event timer.
"""
