'''
Ray-scene intersection.

Reference: ptina_tpu/intersect/__init__.py.  Ported: the hit contract
(plucker), the brute oracle (brute), the dense casts with their CUDA
kernels (dense_cast) and the scene-level routing (dispatch).  The blocked
two-level cast and the BVH builders are later work.
'''
