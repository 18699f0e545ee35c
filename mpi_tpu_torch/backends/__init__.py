"""The port's MPI drivers (counterpart of ``mpi_tpu/backends``): the cuda
driver, one thread per rank over CUDA devices (``cuda.py``), and the
rendezvous its rank pairs share (``rendezvous.py``)."""
