"""Backend-Shim substrate: the compatibility layer of Jointλ (paper §3.2).

Exposes:
  * ``shim``        — effect objects, DSBackend/FaaSBackend abstract APIs
                      (Table 2), the shared runtime types, and the ``Backend``
                      protocol every substrate implements
  * ``datastore``   — strongly-consistent KV/table/object stores (pure state machine)
  * ``simcloud``    — deterministic discrete-event Jointcloud simulator
  * ``billing``     — GB·s / per-op / egress / state-transition / VM-hour accounting
  * ``calibration`` — every latency & price constant, sourced from the paper
  * ``localjax``    — concurrent real-execution backend (workflow nodes run
                      as JAX calls on per-FaaS worker pools)
  * ``remote``      — distributed multi-process substrate (per-cloud forked
                      worker pools, broker queue with lease/visibility-timeout
                      redelivery, WAL-backed shared stores)
"""

from repro_torch.backends import calibration, shim  # noqa: F401
