"""A frozen copy of the plain-PyTorch modules of ``hikari_tpu_torch`` at
commit 5d48e3d, the benchmark's reference. Later changes to the program do
not reach it. What differs from the program: traversal is brute force over
every face (``geometry/brute.py``, no BVH, treelets or sweep kernels), the
scene keeps its faces in input order, only flat scenes build, the
integrators' entry points are in ``portbench/ref/stages.py``, and the
preview's camera lanes can be a subset of pixels. The raw tables
(``hikari_tpu_torch/data/``) are read where the program keeps them."""
