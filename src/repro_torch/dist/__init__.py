"""Distribution of the port (counterpart of the JAX package's
``repro.dist``): `compression` holds the int8 gradient exchange
(`int8_psum_mean`, `int8_ef_psum_mean`) and the exact collectives of the
data-parallel train step over a ``torch.distributed`` process group;
`sharding` the rule table (how params, optimizer state, centroids,
residuals, batches, caches and activations lie on a (data, model) mesh)
and the cut and gather that make a placement real; `tensor_parallel` the
model axis's collectives (the conjugate all-reduce pair, the sequence
gather and reduce-scatter, the vocab-parallel lookup and cross entropy),
which GSPMD inserts in the JAX package."""
from repro_torch.dist import compression  # noqa: F401
