// What the greedy decode loop's two routes share: csrc/decode.cu (the
// chain of kernels a step, and the launch state that captures and replays
// either route) and csrc/decode_step.cu (the step as one launch). The
// argument struct has this one definition: both sources read it, and two
// copies that drifted apart would disagree on its layout without an error.
// The step's plan and the host functions of its source that decode.cu
// calls are declared here.
#pragma once

#include "gemm_mma.cuh"

namespace plank {

// Mirrors the ctypes Structure in ops/persistent_decode.py: every field is
// 8 bytes wide, so both sides agree on the layout without padding rules.
// One field per declaration (tests/test_torch_decode_graph.py parses it).
struct DecodeArgs {
  long long B;
  long long S;
  long long D;
  long long H;
  long long kvH;
  long long Dh;
  long long F;
  long long V;
  long long L;
  long long Li;
  long long dof;
  long long end_token;
  long long is_bf16;
  long long early_exit;
  long long step;           // one launch a step (bf16), not the chain
  // compute-dtype weights, layer-stacked; projections act as x @ W
  const void* wqkv;         // (L, D, W) or (L, W / 8, D, 8)
  const void* bqkv;
  const void* wo;
  const void* bo;
  const void* cwq;
  const void* cbq;
  const void* cwo;
  const void* cbo;
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  const float* ln;          // (L, 6, D): norm1/2/3 scale and bias
  const float* final_ln;    // (2, D)
  // the products' weights row-major (chain) or in strips of 8 columns,
  // (N / 8, K, 8) (step); the head (D, NHp) or (ceil(NH / 4), D, 4), each
  // vocab | pointer | switch | 0 pad
  const float* head_w;
  const float* head_b;      // (V + D + 1)
  const float* emb_value;   // (V, D)
  const float* emb_coord;   // (dof, D)
  const float* emb_pos;     // (ceil(S / dof), D)
  const float* struct_mask; // (S, S)
  const int8_t* ck;         // (L, B, Li, Dkv)
  const int8_t* cv;         // (L, B, Li, Dkv)
  const float* ck_scale;    // (L, B, kvH)
  const float* cv_scale;    // (L, B, kvH)
  const uint8_t* mem_mask;  // (B, Li), 1 = pad
  void* k_cache;            // (L, B, S, Dkv) T
  void* v_cache;            // (L, B, S, Dkv) T
  float* h_cache;           // (B, S, D)
  float* x;                 // (B, D) residual stream, zero at step 0
  float* hf;                // (B, D) this step's final-norm output
  void* q;                  // (B, D) T, self-attention query
  void* att;                // (B, D) T, attention output
  void* q2;                 // (B, D) T, cross-attention query
  void* z;                  // (B, F) T
  float* head_out;          // (B, V + D + 1)
  float* ptr;               // (B, S) this step's pointer logits
  int* output;              // (B, S)
  int* attach;              // (B, S)
  int* done;                // (B)
  int* halt;                // set: every later kernel returns at once
  int* num_steps;           // steps run so far = the current step
  int* counter;             // sampling blocks finished, zero between steps
};

// Programmatic dependent launch: wait until the previous kernel of the
// stream has finished and its writes are visible (a no-op for a launch
// that did not allow the overlap), then let the next kernel's blocks
// start. Every kernel of the loop calls it before it reads anything an
// earlier kernel wrote, `halt` first.
__device__ __forceinline__ void follow_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

constexpr float kNegInf = -1e9f;
constexpr float kEps = 1e-6f;

// the values of T in 16 bytes at p (16-byte aligned) as floats (exact)
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&f)[8]) {
  gemm::bf16x8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}

// the cross-attention's spans of keys and the ranks (parts) of a (row, kv
// head) that take them in turn, on both routes
constexpr int kCrossRanks = 4;
constexpr int kSpan = 64;

// spans a rank takes of Li keys; CL: the ranks, min(kCrossRanks, spans)
__host__ __device__ inline int spans_per_rank(int Li, int& CL) {
  const int nsp = (Li + kSpan - 1) / kSpan;
  CL = nsp < kCrossRanks ? nsp : kCrossRanks;
  return (nsp + CL - 1) / CL;
}

namespace step {

// The row-group plan and the shared-memory layout (byte offsets; the ring
// of weight stages at 0), computed on the host from the input's shapes.
struct Plan {
  int R, C, clusters;  // rows a cluster, cluster size, clusters
  int held;            // the clusters the card holds at once
  // the shapes, as ints (read from the constant bank where used)
  int D, S, L, kvH, Dh, G, F, V, Li, Dkv;
  int xp, a0p, a1p;   // row pitches of the stream, LN and A buffers
  int stage;           // bytes a ring stage
  int ngs;             // self-attention groups of G warps a block
  int aw;              // cross-attention warps a block
  int parts;           // cross-attention parts of a (row, kv head): CL
  int chunks;          // ring chunks a step, the most of any block
  int bias_cols;       // a layer's bias columns, the most of any block
  int xs, a0, a1, qb, work, part, mtab, mrows, scl, sched, bias, hbias, lnp,
      bars, smem;
};

// The plan for `a` on the current device (csrc/decode_step.cu): 0, or a
// CUDA error where the step cannot run these shapes.
int plan(const DecodeArgs& a, Plan& p);

// The step kernel of plan `p` on `s`, a programmatic dependent launch.
int launch(const DecodeArgs& a, const Plan& p, cudaStream_t s);

// The arguments of `a` for a step kernel node of the graph `exec` was
// instantiated from.
int set_args(cudaGraphExec_t exec, cudaGraphNode_t node,
             const DecodeArgs& a, const Plan& p);

}  // namespace step
}  // namespace plank
