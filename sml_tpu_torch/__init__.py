"""PyTorch/CUDA port of sml_tpu on an NVIDIA H100: all seven modes, served and trained
on synthetic data or the IvYGAP / TCGA cohorts, with gene attribution.

The JAX package ``sml_tpu`` is the reference; this package imports none of it
(nor JAX, yaml, sklearn, h5py, pandas, PIL or openpyxl) and keeps its own
copies of what it needs: it reads the cohorts' HDF5 feature files with its
own reader (``data/h5.py``) and their tables with ``csv``.  Every Pallas kernel on the ported path is a hand-written CUDA C++
kernel for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and bound
with ``ctypes`` (``ops/kernels/``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
