// The box-tree walk the port's tree kernels share: the blocked casts
// (blocked_cast.cu), the path megakernel's two casts (fused_path.cu) and
// the dense scene-level casts (dense_cast.cu).
//
// A tree is nodes [2P, 8] (scene.py: compute_node_bounds): an implicit
// complete binary tree in heap layout over leaves of 32 consecutive faces
// of a table, node k with children 2k and 2k + 1, leaf l at node P + l;
// rows (lo.xyz, hi.xyz, 0, 0), padding leaves and nodes inverted.
#pragma once

#include "plucker.cuh"

namespace ptina {

constexpr int kLeafFaces = 32;  // blocked.LEAF_FACES
// the walk's stack over a dense-route table: log2(256 leaves at 8192
// faces) + 1
constexpr int kDenseStack = 9;

// Conservative slab test of the ray against node k's box (two float4:
// lo.xyz hi.x, hi.yz 0 0): false when no point of the box lies ahead of
// the origin; else *entry is a lower bound on the t of any hit inside the
// box.  inv holds the IEEE reciprocals of the ray's direction, taken once
// per walk, so a slab costs a subtraction and a product.  The bounds carry
// the reference's relative margins (1e-6, several times the rounding of
// the reciprocal and the product), so rounding cannot drop a hit whose t
// sits on a box face (the cornell walls lie on their leaves' planes).  A
// zero direction component is decided by the origin alone, so no 0 * inf
// NaN arises (a parked ray points along +z from the origin).
// intersect/blocked.py:box_entries is its torch twin.
__device__ __forceinline__ bool box_entry(const Ray& r, const float* inv,
                                          const float4* __restrict__ nodes,
                                          int k, float* entry) {
  const float4 a = __ldg(nodes + 2 * k);
  const float4 b = __ldg(nodes + 2 * k + 1);
  const float lo[3] = {a.x, a.y, a.z};
  const float hi[3] = {a.w, b.x, b.y};
  const float o[3] = {r.ox, r.oy, r.oz};
  const float d[3] = {r.dx, r.dy, r.dz};
  float near = -INFINITY, far = INFINITY;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    if (!(lo[ax] <= hi[ax])) return false;  // a padding node's inverted box
    if (d[ax] == 0.f) {
      if (o[ax] < lo[ax] || o[ax] > hi[ax]) return false;
      continue;
    }
    const float t1 = (lo[ax] - o[ax]) * inv[ax];
    const float t2 = (hi[ax] - o[ax]) * inv[ax];
    near = fmaxf(near, fminf(t1, t2));
    far = fminf(far, fmaxf(t1, t2));
  }
  near = near * (1.0f - 1e-6f);
  far = far * (1.0f + 1e-6f);
  if (!(far > 0.f && near <= far && isfinite(near))) return false;
  *entry = fmaxf(near, 0.f);
  return true;
}

// Depth-first walk of the box tree over p leaf slots, nearer child first,
// with a kStack-entry stack (log2(p) + 1 entries suffice).  pruned(entry)
// says whether a box entered at `entry` can still matter; it is asked
// again when a deferred node is popped, since the ray's state has moved
// on.  leaf(l) tests leaf l's faces and returns true to end the walk.
// visits, when given, receives (inner nodes visited, leaves tested).
//
// The order of the loop is Aila and Laine's while-while ("Understanding
// the Efficiency of Ray Traversal on GPUs", HPG 2009): a thread descends
// through inner nodes until it holds a leaf before it tests faces, so the
// threads of a warp test their leaves together instead of waiting on each
// other's box tests.  The root's box is not tested (its children's tests
// cull whatever it would).  kBoxes false walks the leaves in slot order
// with no box test: for a tree of one or two leaves (at most 64 faces),
// where the box tests cost more than they can cull.  The result does not
// depend on the visit order.
template <int kStack, bool kBoxes, class Pruned, class Leaf>
__device__ __forceinline__ void walk_tree(const Ray& r,
                                          const float4* __restrict__ nodes,
                                          int p, Pruned pruned, Leaf leaf,
                                          int2* visits) {
  int inner = 0, leaves = 0;
  if (!kBoxes) {
    for (int l = 0; l < p; ++l) {
      ++leaves;
      if (leaf(l)) break;
    }
    if (visits) *visits = make_int2(inner, leaves);
    return;
  }
  const float inv[3] = {1.0f / r.dx, 1.0f / r.dy, 1.0f / r.dz};
  int stack_node[kStack];
  float stack_entry[kStack];
  int sp = 0;
  // the last deferred node the gate still lets through, or 0
  auto pop = [&]() {
    while (sp > 0) {
      --sp;
      if (!pruned(stack_entry[sp])) return stack_node[sp];
    }
    return 0;
  };
  // the root, whose box is not tested: entered at 0 at the earliest
  int node = pruned(0.f) ? 0 : 1;
  while (node) {
    while (node && node < p) {
      ++inner;
      const int c = 2 * node;
      float e0, e1;
      const bool h0 = box_entry(r, inv, nodes, c, &e0) && !pruned(e0);
      const bool h1 = box_entry(r, inv, nodes, c + 1, &e1) && !pruned(e1);
      if (h0 && h1) {
        const bool right_first = e1 < e0;  // a tie goes left first
        stack_node[sp] = right_first ? c : c + 1;
        stack_entry[sp] = right_first ? e0 : e1;
        ++sp;
        node = right_first ? c + 1 : c;
      } else if (h0 || h1) {
        node = h0 ? c : c + 1;
      } else {
        node = pop();
      }
    }
    if (!node) break;
    ++leaves;
    if (leaf(node - p)) break;
    node = pop();
  }
  if (visits) *visits = make_int2(inner, leaves);
}

}  // namespace ptina
