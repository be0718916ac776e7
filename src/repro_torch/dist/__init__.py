"""Distribution of the port (counterpart of the JAX package's
``repro.dist``, its data axis only): `compression` holds the int8
gradient exchange (`int8_psum_mean`, `int8_ef_psum_mean`) and the exact
collectives of the data-parallel train step over a ``torch.distributed``
process group. The rule table (``sharding``) waits for ROADMAP item 10."""
from repro_torch.dist import compression  # noqa: F401
