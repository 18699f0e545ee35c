"""Twins of the JAX package's reference examples (``examples/``) on the
port's driver, run as modules::

    python -m mpi_tpu_torch.examples.helloworld --mpi-ranks 4
    python -m mpi_tpu_torch.examples.bounce --mpi-ranks 2

Add ``--mpi-device cpu`` to run them on the CPU.
"""
