from .tree import tree_where
from .timing import Timer, timed
from .platform import (KERNEL_BACKEND, force_cpu, resolve_backend,
                       use_compile_cache)
