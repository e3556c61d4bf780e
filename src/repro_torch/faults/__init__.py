"""Device-fault modelling: seeded fault campaigns, the ``device``
fidelity backend, and the restore-scrub repair channel.

  * ``FaultModel`` / ``measured_fault_model`` - composable, seeded fault
    channels (restore confusion at the measured TL yield, stuck-at,
    conductance variation, drift): ``faults.model``.
  * ``register_device_backend`` / ``set_fault_model`` /
    ``get_fault_model`` - the ``fidelity='device'`` execution backend
    (the analog MAC through sampled conductances and ``adc_transfer``):
    ``faults.backend``.
  * ``scrub_packed_params`` / ``disturb_packed_params`` /
    ``packed_trit_error_rate`` / ``adc_probe`` - the schedulers'
    per-chunk drift and periodic restore-scrub: ``faults.scrub``.

Every draw is a ``core.prng`` draw, bit for bit the reference's
``jax.random`` draw of the same campaign.
"""
from .model import FaultModel, measured_fault_model          # noqa: F401
from .backend import (DEVICE_BACKEND, device_ternary_mac,    # noqa: F401
                      get_fault_model, register_device_backend,
                      rows_as_calls, set_fault_model,
                      weight_trit_planes)
from .scrub import (adc_probe, disturb_packed_params,        # noqa: F401
                    packed_to_trits, packed_trit_error_rate,
                    scrub_packed_params, trits_to_packed)

__all__ = [
    "DEVICE_BACKEND", "FaultModel", "adc_probe", "device_ternary_mac",
    "disturb_packed_params", "get_fault_model", "measured_fault_model",
    "packed_to_trits", "packed_trit_error_rate",
    "register_device_backend", "rows_as_calls", "scrub_packed_params",
    "set_fault_model",
    "trits_to_packed", "weight_trit_planes",
]
