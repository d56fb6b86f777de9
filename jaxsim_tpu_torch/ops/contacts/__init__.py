from .relaxed_rigid import RelaxedRigidContacts, RelaxedRigidContactsParams
from .soft import SoftContacts, SoftContactsParams
