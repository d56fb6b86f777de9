"""Contact API: parameter estimation.

Counterpart of ``estimate_good_contact_parameters`` in
``jaxsim_tpu/api/contact.py``; soft contacts are the only contact model
ported so far. The rest of that module waits for the functional API.
"""

from __future__ import annotations

from jaxsim_tpu_torch.ops.contacts.soft import SoftContactsParams


def estimate_good_contact_parameters(model, **kwargs) -> SoftContactsParams:
    """Default contact parameters from the model mass."""
    return SoftContactsParams.build_default_from_jaxsim_model(model, **kwargs)
