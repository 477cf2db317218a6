'''
Ray-scene intersection.

Reference: ptina_tpu/intersect/__init__.py.  Ported: the hit contract
(plucker), the brute oracle (brute), the dense casts (dense_cast) and the
blocked two-level casts (blocked) with their CUDA kernels, and the routing
(dispatch) with its table-level entry points, exported here as in the
reference; and the BVH oracles, the Karras linear BVH with its lockstep
traversal (lbvh) and the middle-split BVH (middlebvh), plain torch.
'''

from ptina_tpu_torch.intersect.brute import Hit  # noqa: F401
from ptina_tpu_torch.intersect.dispatch import (  # noqa: F401
    cast_closest, cast_any)
