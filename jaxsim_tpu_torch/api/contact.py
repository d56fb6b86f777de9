"""Contact API: parameter estimation.

Counterpart of ``estimate_good_contact_parameters`` in
``jaxsim_tpu/api/contact.py``, for the soft and relaxed-rigid contact models.
The rest of that module waits for the functional API.
"""

from __future__ import annotations


def estimate_good_contact_parameters(model, **kwargs):
    """Default parameters of the model's contact model: the soft model's
    estimated from the model mass, the relaxed-rigid model's its own."""
    return model.contact_model._parameters_class.build_default_from_jaxsim_model(model, **kwargs)
