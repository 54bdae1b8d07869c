"""The port's tools: ``probe_hash_primitives``, the card's gather, scatter,
bulk-copy and on-chip-capacity rates at the hash-grid model's sizes; the
measurement scripts ``bench_step``, ``bench_breakdown``, ``profile_step``,
``bench_multihost``, ``bench_sampler_machinery`` and
``bench_sdf_grad_kernel`` (the JAX package's ``scripts/`` counterparts);
and the quality, witness, parity and scene tools beside them."""
