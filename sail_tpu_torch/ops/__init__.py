"""Relational kernels over tensors: sort/compact/limit, grouped
aggregation, key hashing, equi-joins and runtime join filters (the
counterpart of ``sail_tpu/ops``)."""
