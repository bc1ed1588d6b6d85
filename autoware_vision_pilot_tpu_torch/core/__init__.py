from .dtypes import Policy, PARITY, FAST, default_policy
from .mesh import make_mesh, data_sharding, replicated
