"""Math kernels: GF(2^8) tables, bit-matrix expansion, the plain torch
versions of the device kernels and their CUDA counterparts (``csrc/``)."""
