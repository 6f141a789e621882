"""heat_tpu_torch core: runtime (communication, devices, the dtype lattice,
factories, the DNDarray, sanitation, memory, printing, the estimator base,
random, I/O) and the op surface (arithmetic, exponential, trigonometric,
rounding, logical, complex, relational, statistics, manipulations, linalg),
exported flat as in heat_tpu.core."""

from . import version
from .version import __version__
from . import communication
from .communication import Communication, MeshComm, MPICommunication, MPIRequest, get_comm, sanitize_comm, use_comm
from . import types
from .types import *
from . import devices
from .devices import Device, cpu, get_device, gpu, sanitize_device, use_device
from . import constants
from .constants import *
from .dndarray import DNDarray, LocalIndex
from . import envparse
from .envparse import env_int
from . import factories
from .factories import *
from . import _operations
from . import sanitation
from .sanitation import *
from . import stride_tricks
from .stride_tricks import *
from . import memory
from .memory import *
from . import printing
from .printing import *
from . import base
from .base import *
from . import arithmetics
from .arithmetics import *
from . import relational
from .relational import *
from . import statistics
from .statistics import *
from . import exponential
from .exponential import *
from . import trigonometrics
from .trigonometrics import *
from . import rounding
from .rounding import *
from . import logical
from .logical import *
from . import complex_math
from .complex_math import *
from . import manipulations
from .manipulations import *
from . import indexing
from .indexing import *
from . import io
from .io import *
from . import random
from . import linalg
from .linalg import *
from . import signal
from .signal import *
from . import tiling
from .tiling import *
