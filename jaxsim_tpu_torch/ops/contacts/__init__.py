from .soft import SoftContactsParams
