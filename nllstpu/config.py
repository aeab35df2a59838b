"""Global configuration for the nllstpu framework.

The reference solver (NLLSsolver.jl) computes everything in Float64 and its
test targets require final costs < 1e-15 (see /root/reference/test/optimizeba.jl:64-75),
which is unreachable in f32.  We therefore enable JAX x64 globally at import
time; individual problems may still opt into float32 for speed on the GPU via the
``dtype`` argument of :class:`nllstpu.Problem`.
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

#: Default scalar dtype for solver state (matches the reference's Float64).
default_dtype = jnp.float64

#: Maximum number of variable blocks a single cost may depend on.  Mirrors the
#: reference's ``MAX_ARGS = 10`` (src/NLLSsolver.jl:28), though nothing in this
#: framework structurally requires the bound — it is kept as an API sanity
#: check when registering costs.
MAX_ARGS = 10
