"""heat_tpu_torch core: runtime, dtype lattice and the op surface of the
KMeans, linear-algebra and Lasso slices, exported flat as in heat_tpu.core."""

from . import communication
from .communication import Communication, MeshComm, get_comm, sanitize_comm, use_comm
from . import types
from .types import *
from . import devices
from .devices import cpu, get_device, gpu, sanitize_device, use_device
from . import constants
from .constants import *
from .dndarray import DNDarray
from . import factories
from .factories import *
from . import _operations
from . import sanitation
from . import stride_tricks
from . import base
from . import arithmetics
from .arithmetics import *
from . import relational
from .relational import *
from . import statistics
from .statistics import *
from . import exponential
from .exponential import *
from . import manipulations
from .manipulations import *
from . import random
from . import linalg
from .linalg import *
