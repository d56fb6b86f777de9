from .collision import BoxCollision, CollidablePoint, CollisionShape, SphereCollision
from .joint import JointDescription, JointGenericAxis, JointType
from .link import LinkDescription
from .model import ModelDescription
