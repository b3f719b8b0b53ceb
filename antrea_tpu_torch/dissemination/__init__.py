"""Dissemination helpers the engine needs: the wire serialization of the
control-plane types (serde.py) and the deterministic fault plans
(faults.py), copies of the JAX package's modules."""
