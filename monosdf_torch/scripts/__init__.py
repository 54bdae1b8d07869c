"""The port's tools: ``probe_hash_primitives``, the card's gather, scatter,
bulk-copy and on-chip-capacity rates at the hash-grid model's sizes."""
