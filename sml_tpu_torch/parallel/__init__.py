"""Several processes, one device each (counterpart of ``sml_tpu/parallel/``).

The JAX package runs one program over a mesh and lets jit insert the
collectives; the port runs one process per device and makes them itself, from
``all_gather`` and ``all_reduce`` alone (``collectives``):

* data parallelism: each rank of a data group holds a slice of the global
  batch, the losses see the gathered outputs of the whole batch, and the
  gradients are summed over the group (``mesh``);
* cross-rank BatchNorm: moments over the data group (``batchnorm``);
* sequence parallelism: the ranks of a seq group hold one batch and split the
  token rows of the Nystrom attention (``seq_parallel``) and of the 2-D
  deformable cross-attention (``seq_deform``);
* the bootstrap, ``initialize`` (``distributed``).
"""
