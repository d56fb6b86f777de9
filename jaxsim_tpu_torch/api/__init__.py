from . import contact, kin_dyn_parameters, model
from .model import JaxSimModel
