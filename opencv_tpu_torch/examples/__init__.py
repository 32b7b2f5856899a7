"""The port's applications: the JAX package's seven examples (`examples/`
at the repository root) as entry points of the port, under the same names.

    python -m opencv_tpu_torch.examples.vo_synthetic [--cpu] [--frames N]
    python -m opencv_tpu_torch.examples.tbd_app [--cpu] [--frames N] ...
    python -m opencv_tpu_torch.examples.lane_detection [--cpu]
    python -m opencv_tpu_torch.examples.calibration_app [--cpu] [--views N] [--noise PX]
    python -m opencv_tpu_torch.examples.segmentation_demo [--cpu]
    python -m opencv_tpu_torch.examples.qr_demo [--cpu] [--text "..."]
    python -m opencv_tpu_torch.examples.panorama [--cpu] [--out panorama.png]

Each runs on the card, and raises without one unless `--cpu` is given;
takes its JAX counterpart's flags with the same names and defaults; prints
the JAX example's lines in the same order and format; builds the same
scene from the same seeds; and exits as the JAX example does. Importing an
app parses no argument and touches no device: `main(argv)` does the work
and returns every figure the app prints, with the app's verdict as `ok`.
Where the JAX example draws from a JAX PRNG (the RANSACs of `vo_synthetic`
and `panorama`), the port draws from its own `torch.Generator`.
"""
