// The path megakernel for Hopper (sm_90a): one whole progressive sample,
// every bounce of every path, in one launch.
//
// Replaces ptina_tpu/engine/fused.py::_path_kernel (launched by
// _fused_call) in its three heads (PtinaPathParams::head):
//   primary  (fused_trace_primary): the kernel makes the camera rays and
//            the whole Sobol + wang-hash uniform stream itself;
//   explicit (fused_trace_uniforms): given rays and a [2 + 6 depth, N]
//            uniform block (MLT replay, the forward of the gradient pair);
//   rays     (fused_trace): given rays and a per-ray hash base[i] (the
//            sampling.wanghash2 bit pattern), the uniform stream made in
//            the kernel from the Sobol point and base[i], as the primary
//            head makes it from the pixel's hash.
// The primary and explicit heads share one kernel and pick at run time
// (PtinaPathParams::head), as they always have; the rays head is an
// instantiation of its own (kRays), so its code adds no register or
// spill to theirs (chip_smoke.py prints ptxas's for each instantiation).
// It computes what path_trace computes (engine/path.py, the plain twin
// through engine/fused.py:fused_trace_*_plain): per bounce a closest cast
// with attributes, the material row with texture modulation, the light
// hit with MIS, the environment on a miss, a light sample with its shadow
// cast, the Disney eval, and the Disney sample (skipped on the last
// bounce).  Out: radiance r, g, b [N].
//
// What bounds it on this card: the casts.  A brute cast meets every face
// (~36 FP32 operations a pair) twice per bounce, against a few hundred
// operations of shading per bounce: at 984 faces ~97% of the arithmetic.
// The only device-memory traffic is the 12 B written per path (and, in the
// explicit head, its rays and uniforms read once): the face table (<= 8192
// x 136 B), the tree, materials, lights and texture atlas are read through
// the L1/L2 caches, where they stay.
//
// What the design does about it: one thread per path, 128-thread blocks,
// the path's state in registers and the bounce loop inside the thread.
// Both casts walk the scene's box tree over 32-face leaves (tree.cuh:
// walk_tree; scene.py: fused_nodes over the faces in fused_order, whose
// coefficient rows are fused_coef), nearer child first, with a 9-entry
// stack (<= 256 leaves at 8192 faces); a table of at most two leaves
// (the cornell scenes) is tested leaf by leaf, in a kernel of its own.
// The closest cast prunes a node whose entry, floored to the key's t grid
// (& ~fid_mask), is strictly beyond the running best, and keys by the face's original id, so the
// result is the packed-key minimum over every face, whatever the visit
// order; the shadow cast prunes entries at or beyond tmax and stops at its
// first occluder.  The self-hit exclusion is held as the last winner's
// tree slot, which names the same face as its id.  The TPU kernel's layout
// does not survive: no [RG, TR] tiles, no Plücker-as-matmul casts or
// one-hot winner extraction, no one-hot material switch, no weight-matmul
// texture fetch, no atan2 polynomial.  Faces and boxes are read with
// __ldg, and there is no block barrier, so a thread leaves its bounce loop
// as soon as its path dies (a dead path adds nothing more in the reference
// either).  The BSDF branches on the lobe decision instead of evaluating
// every lobe (disney.cuh).
//
// Numerics: built with --fmad=false, no fast math (utils/cuda_build.py).
// The uniforms equal sampling/sobol.sample_dims bit for bit: the hash
// converts with one rounding (__uint2float_rn(h) * 2^-32), as the port's
// u32_to_unit does, where the TPU kernel's _u32f rounds twice.  The casts
// follow plucker.cuh's contract, as the wavefront's kernels do.
#include <cuda_runtime.h>

#include <cstddef>

#include "disney.cuh"
#include "lights.cuh"
#include "plucker.cuh"
#include "tree.cuh"
#include "vec.cuh"

namespace ptina {
namespace {

constexpr int kBlock = 128;  // paths per block
constexpr int kMaxDims = 98;  // the primary head's Sobol point: sobol.MAX_DIMS
// PtinaPathParams::head (engine/fused.py: _HEAD_*)
constexpr int kHeadExplicit = 0;
constexpr int kHeadPrimary = 1;
constexpr int kHeadRays = 2;
constexpr unsigned kGold = 0x9e3779b9u;
constexpr float kTwoPowM32 = static_cast<float>(1.0 / 4294967296.0);

}  // namespace
}  // namespace ptina

// Launch parameters, passed by value.  The layout is mirrored by the
// ctypes Structure in engine/fused.py (_Params): keep the two in step.
struct PtinaPathParams {
  const float4* coef;        // [F, 16] face coefficients (plucker.pack_faces)
  const float* attr;         // [F, 18] corner attributes
  const float* mat_fac;      // [M + 1, 12, 4]; row M = defaults (mtlid -1)
  const int* mat_tex;        // [M + 1, 12] texture ids (-1 = none)
  const float* light_pos;    // [L, 3]
  const float* light_color;  // [L, 3]
  const float* light_axes;   // [L, 3, 3]
  const float* light_size;   // [L]
  const int* light_type;     // [L]
  const int* light_count;    // []
  const float* tex_data;     // [T, H, W, 4]
  const int* tex_nx;         // [T]
  const int* tex_ny;         // [T]
  const float* world_fac;    // [4]
  const float* cam;          // [4, 4] view -> world (primary head)
  const float* ray_o[3];     // [N] each (explicit and rays heads)
  const float* ray_d[3];
  const float* uniforms;     // [2 + 6 depth, N] (explicit head)
  const int* base;           // [N] per-ray hash (rays head)
  float* out;                // [3, N]
  const float4* tree_coef;   // [F, 16] face_coef in tree slot order
  const float4* nodes;       // [2 tree_p, 8] the box tree (tree.cuh)
  const int* order;          // [F] the face id of each tree slot
  int2* visits;              // null, or [N, depth, 2] per-cast counters
  int n, f, tree_p, fid_mask, mat_rows, light_slots, tex_h, tex_w;
  int use_tex;   // the atlas holds textures (mtllib modulation on)
  int env_tex;   // equirect environment texture id, -1 = constant
  int depth;
  int zero;      // Materials.zero as disney.cuh kZero* bits
  int kinds;     // bit 0: a point light exists, bit 1: an area light
  int head;      // kHeadExplicit, kHeadPrimary or kHeadRays
  int x0, y0, tile_ny;  // primary: tile offset and rows per film column
  float fnx, fny;       // primary: full film size
  float pt[ptina::kMaxDims];  // primary and rays: the sample's Sobol point
};

namespace ptina {
namespace {

// sampling.wanghash on u32
__device__ __forceinline__ unsigned wanghash(unsigned x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27d4eb2du;
  x ^= x >> 15;
  return x;
}

// uniform row d of path i: sample_dims' remainder(pt[d] + rotation, 1)
// in the primary and rays heads, the given block in the explicit one
template <bool kRays>
__device__ __forceinline__ float uniform(const PtinaPathParams& p,
                                         unsigned pbase, int d, int i) {
  if (kRays || p.head != kHeadExplicit) {
    const float rot = __uint2float_rn(wanghash(pbase + d * kGold)) *
                      kTwoPowM32;
    const float u = p.pt[d] + rot;
    return u - floorf(u);
  }
  return __ldg(p.uniforms + static_cast<size_t>(d) * p.n + i);
}

// torch.remainder of integers: the non-negative residue
__device__ __forceinline__ long long wrap(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

// texture.sample_texture: bilinear, wrap-around, over (s (nx - 1),
// t (ny - 1)) of texture tid in the padded [T, H, W, 4] atlas
__device__ __forceinline__ float4 sample_texture(const PtinaPathParams& p,
                                                 int tid, float s, float t) {
  const int nx = __ldg(p.tex_nx + tid), ny = __ldg(p.tex_ny + tid);
  const float px = s * static_cast<float>(nx - 1);
  const float py = t * static_cast<float>(ny - 1);
  const float flx = floorf(px), fly = floorf(py);
  const float fx = px - flx, fy = py - fly;
  // a non-finite coordinate gives NaN weights (and a NaN texel) as in
  // torch; the index only has to stay in range
  const long long ix = fabsf(flx) < 1e18f ? static_cast<long long>(flx) : 0;
  const long long iy = fabsf(fly) < 1e18f ? static_cast<long long>(fly) : 0;
  const long long mx = max(nx, 1), my = max(ny, 1);
  const long long x0 = wrap(ix, mx), x1 = wrap(ix + 1, mx);
  const long long y0 = wrap(iy, my), y1 = wrap(iy + 1, my);
  const float4* d = reinterpret_cast<const float4*>(p.tex_data) +
                    static_cast<long long>(tid) * p.tex_h * p.tex_w;
  const float4 f00 = __ldg(d + x0 * p.tex_w + y0);
  const float4 f01 = __ldg(d + x0 * p.tex_w + y1);
  const float4 f10 = __ldg(d + x1 * p.tex_w + y0);
  const float4 f11 = __ldg(d + x1 * p.tex_w + y1);
  const float a = 1.0f - fx, b = 1.0f - fy;
  float4 r;
  r.x = f11.x * fx * fy + f10.x * fx * b + f00.x * a * b + f01.x * a * fy;
  r.y = f11.y * fx * fy + f10.y * fx * b + f00.y * a * b + f01.y * a * fy;
  r.z = f11.z * fx * fy + f10.z * fx * b + f00.z * a * b + f01.z * a * fy;
  r.w = f11.w * fx * fy + f10.w * fx * b + f00.w * a * b + f01.w * a * fy;
  return r;
}

// mtllib.fetch_material: the material row (mtlid -1, or an id without a
// row = defaults), texture modulation of its bound parameters, then
// disney_derive
__device__ __forceinline__ Material fetch_material(const PtinaPathParams& p,
                                                   int mtlid, float s,
                                                   float t) {
  const int row = mtlid < 0 || mtlid >= p.mat_rows ? p.mat_rows - 1 : mtlid;
  const float* fac = p.mat_fac + 48 * row;  // [12, 4]
  float v[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = __ldg(fac + 4 * k);
  Material m;
  m.basecolor = v3(v[0], __ldg(fac + 1), __ldg(fac + 2));
  if (p.use_tex) {
    const int* tex = p.mat_tex + 12 * row;
    for (int k = 0; k < 12; ++k) {
      const int tid = __ldg(tex + k);
      if (tid < 0) continue;
      const float4 tv = sample_texture(p, tid, s, t);
      if (k == 0)
        m.basecolor = m.basecolor * v3(tv.x, tv.y, tv.z);
      else
        v[k] = v[k] * tv.x;
    }
  }
  m.metallic = v[1];
  m.roughness = v[2];
  m.specular = v[3];
  m.specularTint = v[4];
  m.subsurface = v[5];
  m.sheen = v[6];
  m.sheenTint = v[7];
  m.clearcoat = v[8];
  m.clearcoatGloss = v[9];
  m.transmission = v[10];
  m.ior = v[11];
  disney_derive(&m);
  return m;
}

// lights.world_at: the constant environment, or the equirect texture with
// the blender swizzle (x, z, -y)
__device__ __forceinline__ V3 world_at(const PtinaPathParams& p, V3 rd) {
  const V3 fac = v3(__ldg(p.world_fac), __ldg(p.world_fac + 1),
                    __ldg(p.world_fac + 2));
  if (p.env_tex < 0) return fac;
  const V3 d = vnormalize(v3(rd.x, rd.z, -rd.y));
  const float s = atan2f(d.z, d.x) / kPi * 0.5f + 0.5f;
  const float t = atan2f(d.y, safe_sqrt(d.x * d.x + d.z * d.z)) / kPi + 0.5f;
  const float4 tv = sample_texture(p, p.env_tex, s, t);
  return v3(tv.x, tv.y, tv.z) * fac;
}

// engine/path.power_heuristic
__device__ __forceinline__ float power_heuristic(float a, float b) {
  a = clampf(a, kEps, kInf);
  b = clampf(b, kEps, kInf);
  a = a * a;
  b = b * b;
  return a / (a + b);
}

// closest cast: the packed-key minimum over every face but the one in
// tree slot `avoid`; *slot receives the winner's tree slot
template <bool kBoxes>
__device__ __forceinline__ int closest_key(const PtinaPathParams& p,
                                           const Ray& r, int avoid,
                                           int* slot, int2* visits) {
  int best = kKeyMiss;
  int best_slot = -1;
  walk_tree<kDenseStack, kBoxes>(
      r, p.nodes, p.tree_p,
      // a box whose every hit is strictly beyond the running best on the
      // key's t grid (KEY_MISS keeps every box in play)
      [&](float entry) {
        return (__float_as_int(entry) & ~p.fid_mask) > (best & ~p.fid_mask);
      },
      [&](int l) {
        const int base = l * kLeafFaces;
        const int cnt = min(kLeafFaces, p.f - base);
        const float4* c = p.tree_coef + 4 * base;
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          float t;
          const bool valid =
              face_hit(r, __ldg(c + 4 * j), __ldg(c + 4 * j + 1),
                       __ldg(c + 4 * j + 2), __ldg(c + 4 * j + 3), &t);
          if (valid && base + j != avoid && t < kInf) {
            // keys are distinct (the id field), so the slot follows
            const int k = pack_key(t, __ldg(p.order + base + j), p.fid_mask);
            if (k < best) {
              best = k;
              best_slot = base + j;
            }
          }
        }
        return false;
      },
      visits);
  *slot = best_slot;
  return best;
}

// shadow cast: a valid hit on a face but the one in tree slot `avoid` at
// t < min(tmax, INF)
template <bool kBoxes>
__device__ __forceinline__ bool occluded(const PtinaPathParams& p,
                                         const Ray& r, int avoid, float tmax,
                                         int2* visits) {
  bool occ = false;
  walk_tree<kDenseStack, kBoxes>(
      r, p.nodes, p.tree_p, [&](float entry) { return entry >= tmax; },
      [&](int l) {
        const int base = l * kLeafFaces;
        const int cnt = min(kLeafFaces, p.f - base);
        const float4* c = p.tree_coef + 4 * base;
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          float t;
          const bool valid =
              face_hit(r, __ldg(c + 4 * j), __ldg(c + 4 * j + 1),
                       __ldg(c + 4 * j + 2), __ldg(c + 4 * j + 3), &t);
          if (valid && base + j != avoid && t < kInf && t < tmax) {
            occ = true;
            return true;
          }
        }
        return false;
      },
      visits);
  return occ;
}

// cast c (0 closest, 1 shadow) of bounce b of path i in the counters
__device__ __forceinline__ int2* visit_slot(const PtinaPathParams& p, int i,
                                            int b, int c) {
  return p.visits
             ? p.visits + (static_cast<size_t>(i) * p.depth + b) * 2 + c
             : nullptr;
}

// camera.camera_rays: unproject the near and far points of NDC (x, y)
__device__ __forceinline__ V3 unproject(const float* m, float x, float y,
                                        float z) {
  const float px = __ldg(m + 0) * x + __ldg(m + 1) * y + __ldg(m + 2) * z +
                   __ldg(m + 3);
  const float py = __ldg(m + 4) * x + __ldg(m + 5) * y + __ldg(m + 6) * z +
                   __ldg(m + 7);
  const float pz = __ldg(m + 8) * x + __ldg(m + 9) * y + __ldg(m + 10) * z +
                   __ldg(m + 11);
  const float pw = __ldg(m + 12) * x + __ldg(m + 13) * y +
                   __ldg(m + 14) * z + __ldg(m + 15);
  const float inv = 1.0f / pw;
  return v3(px * inv, py * inv, pz * inv);
}

// kBoxes: the casts test the tree's boxes (more than two leaves); a table
// of one or two leaves (at most 64 faces: the cornell scenes) takes the
// instantiation without them, whose registers are the shading's alone.
// kRays: the rays head; else the primary or the explicit head, as
// PtinaPathParams::head says.
// At least 6 blocks of 128 an SM: ptxas then spills a little of the box
// walk's state to L1-resident local memory, which costs less than the
// occupancy it buys.
template <bool kBoxes, bool kRays>
__global__ void __launch_bounds__(kBlock, 6)
path_kernel(const __grid_constant__ PtinaPathParams p) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= p.n) return;

  V3 ro, rd;
  unsigned pbase = 0;
  if (!kRays && p.head != kHeadExplicit) {
    // pixel_grid order: x major over the tile's columns
    const int ii = p.x0 + i / p.tile_ny;
    const int jj = p.y0 + i % p.tile_ny;
    pbase = wanghash(wanghash(static_cast<unsigned>(ii)) +
                     static_cast<unsigned>(jj));
    const float x =
        (static_cast<float>(ii) + uniform<kRays>(p, pbase, 0, i)) / p.fnx *
            2.0f - 1.0f;
    const float y =
        (static_cast<float>(jj) + uniform<kRays>(p, pbase, 1, i)) / p.fny *
            2.0f - 1.0f;
    ro = unproject(p.cam, x, y, -1.0f);
    rd = vnormalize(unproject(p.cam, x, y, 1.0f) - ro);
  } else {
    ro = v3(__ldg(p.ray_o[0] + i), __ldg(p.ray_o[1] + i),
            __ldg(p.ray_o[2] + i));
    rd = v3(__ldg(p.ray_d[0] + i), __ldg(p.ray_d[1] + i),
            __ldg(p.ray_d[2] + i));
    if constexpr (kRays)
      pbase = static_cast<unsigned>(__ldg(p.base + i));
  }

  LightPool lp;
  lp.pos = p.light_pos;
  lp.color = p.light_color;
  lp.axes = p.light_axes;
  lp.size = p.light_size;
  lp.type = p.light_type;
  lp.slots = p.light_slots;
  lp.count = __ldg(p.light_count);
  lp.has_point = p.kinds & 1;
  lp.has_area = p.kinds & 2;

  V3 throughput = v3(1.0f, 1.0f, 1.0f);
  V3 result = v3(0.0f, 0.0f, 0.0f);
  float last_brdf_pdf = kInf;  // full first-hit emitter weight
  int avoid = -1;  // self-hit exclusion: the tree slot of the last face hit

  for (int b = 0; b < p.depth; ++b) {
    const int d0 = 2 + 6 * b;
    rd = vnormalize(rd);

    // closest hit + attributes (dense_cast.cu::shade_kernel's contract)
    const Ray ray = make_ray(ro.x, ro.y, ro.z, rd.x, rd.y, rd.z);
    int slot;
    const int key =
        closest_key<kBoxes>(p, ray, avoid, &slot, visit_slot(p, i, b, 0));
    const bool hit = key != kKeyMiss;
    float t = kInf;
    int idx = -1;
    float at[kChannels] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (hit) {
      idx = key & p.fid_mask;
      t = key_decode_t(key, p.fid_mask);
      float u, v;
      winner_uv(ray, reinterpret_cast<const float*>(p.coef) + idx * kCoef,
                &u, &v);
      const float w0 = 1.0f - u - v;
      const float* a = p.attr + idx * kAttr;
#pragma unroll
      for (int c = 0; c < kChannels; ++c)
        at[c] = __ldg(a + c) * w0 + __ldg(a + kChannels + c) * u +
                __ldg(a + 2 * kChannels + c) * v;
    }

    // direct light hit with MIS against the previous BSDF pdf
    float ldis, lpdf;
    V3 lcolor;
    const bool lhit = lights_hit(lp, ro, rd, &ldis, &lpdf, &lcolor);
    if (lhit && (!hit || ldis < t))
      result = result + throughput * lcolor *
                            power_heuristic(last_brdf_pdf, lpdf);

    // the environment on a miss, and the path ends
    if (!hit) {
      result = result + throughput * world_at(p, rd);
      break;
    }

    V3 normal = vnormalize(v3(at[0], at[1], at[2]));
    const V3 hitpos = ro + rd * t;
    const float sign = -vdot(rd, normal);
    normal = sign < 0.0f ? -normal : normal;
    const Material m =
        fetch_material(p, __float2int_rn(at[5]), at[3], at[4]);

    // next-event estimation: light sample, shadow cast, BSDF eval, MIS
    float li_dis, li_pdf;
    V3 li_dir, li_color;
    lights_sample(lp, hitpos, uniform<kRays>(p, pbase, d0, i),
                  uniform<kRays>(p, pbase, d0 + 1, i),
                  uniform<kRays>(p, pbase, d0 + 2, i), &li_dis, &li_dir,
                  &li_pdf, &li_color);
    if (any3(li_color)) {
      const Ray sray = make_ray(hitpos.x, hitpos.y, hitpos.z, li_dir.x,
                                li_dir.y, li_dir.z);
      if (!occluded<kBoxes>(p, sray, slot, li_dis, visit_slot(p, i, b, 1))) {
        const V3 brdf = disney_eval(m, p.zero, normal, sign, -rd, li_dir);
        const float mis2 = power_heuristic(li_pdf, vavg3(brdf));
        const V3 nee = li_color * brdf * (mis2 * vdot_or_zero(normal, li_dir));
        result = result + throughput * nee;
      }
    }

    // BSDF bounce; its result feeds nothing after the last bounce
    if (b == p.depth - 1) break;
    V3 outdir, color;
    float pdf;
    disney_sample(m, p.zero, normal, sign, -rd,
                  uniform<kRays>(p, pbase, d0 + 3, i),
                  uniform<kRays>(p, pbase, d0 + 4, i),
                  uniform<kRays>(p, pbase, d0 + 5, i), &outdir, &pdf,
                  &color);
    throughput = throughput * color;
    ro = hitpos;
    rd = outdir;
    avoid = slot;
    last_brdf_pdf = pdf;
    if (!any3(throughput) || (rd.x == 0.0f && rd.y == 0.0f && rd.z == 0.0f))
      break;  // a dead path adds nothing more
  }
  p.out[i] = result.x;
  p.out[p.n + i] = result.y;
  p.out[2 * p.n + i] = result.z;
}

// The launch of the rays head (kRays) or of the other two, its
// instantiation by the table's leaves.
template <bool kRays>
void launch_head(const PtinaPathParams& p, int grid, cudaStream_t s) {
  if (p.tree_p > 2)
    path_kernel<true, kRays><<<grid, kBlock, 0, s>>>(p);
  else
    path_kernel<false, kRays><<<grid, kBlock, 0, s>>>(p);
}

}  // namespace
}  // namespace ptina

extern "C" {

// One megakernel launch over p->n paths on `stream`.  Returns
// cudaGetLastError() after the launch.
int ptina_path_trace(const PtinaPathParams* p, void* stream) {
  const int grid = (p->n + ptina::kBlock - 1) / ptina::kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->head == ptina::kHeadRays)
    ptina::launch_head<true>(*p, grid, s);
  else if (p->head == ptina::kHeadPrimary || p->head == ptina::kHeadExplicit)
    ptina::launch_head<false>(*p, grid, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(PtinaPathParams), so the binding can check its mirror.
int ptina_path_params_size() {
  return static_cast<int>(sizeof(PtinaPathParams));
}

}  // extern "C"
