// Deviation-set fast pass on Hopper: one thread per trial lane.  Two
// entry points share one kernel body (taint_fast_kernel):
//
// - taint_fast_launch (K1) replaces shrewd_tpu/ops/pallas_taint.py:513
//   taint_fast_pallas (its body _make_kernel(carry_sets=False), :209-504,
//   and the end classification, :603-626).  Plain PyTorch version:
//   shrewd_tpu_torch/ops/taint.py taint_fast_plain.
// - taint_chunk_launch (K2, CARRY_SETS = true) replaces
//   shrewd_tpu/ops/pallas_taint.py:634 taint_chunk_pallas
//   (_make_kernel(carry_sets=True)): one chunk of the window, the sets
//   seeded from the carried (tags0, vals0) instead of EMPTY, no end
//   classification; it writes the det/trap/div bits, esc, ovf, the sets
//   and the live-step counts.  Plain PyTorch version: ops/taint.py
//   taint_chunk.  The chunked driver (ops/chunked.py) launches it once per
//   wave of a chunk, at B <= 4096 lanes and S = 65536 steps.
//
// The wrappers (shrewd_tpu_torch/ops/taint_cuda.py) use the plain versions
// for CPU tensors, take the golden stream as the record's owner packed it
// (pack_stream, once per record) and order the lanes.
//
// What bounds it on an H100: not bytes (a 64 B record per step, 32 B of
// fault coordinates and a K-slot set per lane).  The work is integer and
// serial in the steps: a lane's step reads the set its earlier steps
// wrote.  A chunk wave of 512 lanes is 16 warps, so one warp's latency per
// step, times the steps it walks, sets the time.  Most of those steps
// change nothing, and the design skips them exactly:
//
// 1. Quiet steps.  Step i is quiet when a lane with an EMPTY set and no
//    fault phase at i stays live after it with its set still empty: no
//    golden memory trap or #DE, no branch mismatch with `taken`, no
//    escape, no upsert.  The wrapper computes that once per golden record
//    in plain torch (taint_cuda.quiet_steps) and packs, per step, a LOUD
//    flag and the first loud step after it.
// 2. Jumps over empty sets.  Outside a fault phase an empty-set lane is
//    the golden run, so it jumps from step i straight to the next step
//    that can change it: its landing (REGFILE: `cycle`, every other kind:
//    `entry`), or the next loud step.  That covers a fresh lane's golden
//    prefix, a lane whose deviation was removed, and the null padding.
//    Reaching n ends the lane live, with steps = n; a lane that dies at
//    step i has steps = i + 1, as the plain scan counts.
// 3. Untouched steps.  On a quiet step that is not its landing, a lane
//    with a non-empty set runs the full body only when the step touches a
//    tag of its set: src1, src2, dst, or the memory word of a golden load
//    or store (nphys + slot(ea), packed per step).  Why an untouched step
//    is a no-op: no fault phase fires, so the operand lookups of src1 and
//    src2 miss and return the golden operands; the ALU result, address,
//    traps, branch and load value are then the golden run's, which is the
//    empty-set lane's, and that lane lives through the quiet step; every
//    remove and upsert the step makes targets dst or that memory word,
//    both absent, and on a quiet step the empty-set lane makes no upsert,
//    so the decisions are the same removes of absent tags: nothing
//    changes.  Membership is tested in two stages: a 64-bit filter of the
//    set's tags (one bit per hashed tag, rebuilt after every full step)
//    against the step's probe (the same bits of the tags it touches,
//    packed per step), which can say "maybe" for an absent tag but never
//    "no" for a present one; then, on a "maybe", an exact K-wide compare,
//    so a filter false positive costs one pass over the slots, not the
//    full body.
// 4. Warps that jump together.  The wrapper sorts the lanes by their
//    start step (landing, 0 when carrying a non-empty set, n for a null
//    lane) and passes the order; a thread reads its lane's inputs and
//    writes its outputs through it.  A warp's step counter is the minimum
//    of its live lanes' next steps (__reduce_min_sync); the other lanes
//    idle.  The stream is step-major, 64 B per step (K2's chunk: 4 MiB, in
//    L2).  Each warp stages it in a tile of 32 steps in shared memory,
//    read as a broadcast, while the next 32 steps are in flight into
//    registers (one step per thread), so a walk waits on L2 once per jump,
//    not once per step.  There is no block-wide barrier: warps move
//    independently.
//
// The set lives in registers: K is a template parameter and every slot
// loop is unrolled, so no set access touches local memory.  Upserts fill
// the lowest matching slot, else the lowest EMPTY one (carried sets may
// hold holes), as the reference does.  Fault coordinates are signed and
// never clamped: a carried lane's negative coordinates never fire.
// Division is native with the #DE lanes giving 0; floating point is IEEE
// round-to-nearest through __f*_rn with explicit subnormal flush and the
// canonical NaN (build with -fmad=false, never --use_fast_math).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false -o libtaint_fast.so taint_fast.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// opcodes (shrewd_tpu_torch/isa/uops.py)
enum : int {
  NOP = 0, ADD, SUB, AND_, OR_, XOR_, SLL, SRL, SRA, ADDI, ANDI, ORI, XORI,
  LUI, MUL, SLT, SLTU, DIV, REM, DIVU, REMU, LOAD, STORE, BEQ, BNE, BLT, BGE,
  FADD, FSUB, FMUL, FDIV, MULHU, N_OPCODES
};

// fault kinds (shrewd_tpu_torch/models/o3.py)
enum : int {
  KIND_REGFILE = 1, KIND_FU, KIND_ROB_DST, KIND_IQ_SRC1, KIND_IQ_SRC2,
  KIND_LSQ_ADDR, KIND_LSQ_DATA, KIND_LATCH_OP, KIND_LATCH_IMM
};

// outcomes (shrewd_tpu_torch/ops/classify.py)
enum : int { MASKED = 0, SDC = 1, DUE = 2, DETECTED = 3 };

// bits of a step's flags (ops/taint_cuda.py pack_stream: op | flags << 8)
enum : int { G_WR = 1, G_LD = 2, G_ST = 4, LOUD = 8, TAKEN = 16 };

constexpr int EMPTY = -1;
constexpr int THREADS = 128;
constexpr int TILE = 32;          // steps of a warp's shared-memory tile
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t flush(uint32_t v) {
  const uint32_t mag = v & 0x7FFFFFFFu;
  return (mag > 0u && mag < 0x00800000u) ? (v & 0x80000000u) : v;
}

__device__ __forceinline__ uint32_t fp_op(int op, uint32_t a, uint32_t b) {
  const float af = __uint_as_float(flush(a));
  const float bf = __uint_as_float(flush(b));
  float r;
  switch (op) {
    case FADD: r = __fadd_rn(af, bf); break;
    case FSUB: r = __fsub_rn(af, bf); break;
    case FMUL: r = __fmul_rn(af, bf); break;
    default:   r = __fdiv_rn(af, bf); break;
  }
  if (isnan(r)) return 0x7FC00000u;
  return flush(__float_as_uint(r));
}

__device__ __forceinline__ bool bad_signed(uint32_t a, uint32_t b) {
  return b == 0u || (a == 0x80000000u && b == 0xFFFFFFFFu);
}

// The µop ALU (shrewd_tpu/ops/replay.py _alu): x86 #DE lanes give 0.
__device__ uint32_t alu(int op, uint32_t a, uint32_t b, uint32_t imm) {
  const uint32_t sh = b & 31u;
  switch (op) {
    case ADD:   return a + b;
    case SUB:   return a - b;
    case AND_:  return a & b;
    case OR_:   return a | b;
    case XOR_:  return a ^ b;
    case SLL:   return a << sh;
    case SRL:   return a >> sh;
    case SRA:   return static_cast<uint32_t>(static_cast<int32_t>(a) >> sh);
    case ADDI:  return a + imm;
    case ANDI:  return a & imm;
    case ORI:   return a | imm;
    case XORI:  return a ^ imm;
    case LUI:   return imm;
    case MUL:   return a * b;
    case SLT:   return static_cast<int32_t>(a) < static_cast<int32_t>(b);
    case SLTU:  return a < b;
    case DIV:
      return bad_signed(a, b) ? 0u : static_cast<uint32_t>(
          static_cast<int32_t>(a) / static_cast<int32_t>(b));
    case REM:
      return bad_signed(a, b) ? 0u : static_cast<uint32_t>(
          static_cast<int32_t>(a) % static_cast<int32_t>(b));
    case DIVU:  return b ? a / b : 0u;
    case REMU:  return b ? a % b : 0u;
    case LOAD: case STORE: return a + imm;     // effective address
    case BEQ:   return a == b;
    case BNE:   return a != b;
    case BLT:   return static_cast<int32_t>(a) < static_cast<int32_t>(b);
    case BGE:   return static_cast<int32_t>(a) >= static_cast<int32_t>(b);
    case FADD: case FSUB: case FMUL: case FDIV: return fp_op(op, a, b);
    case MULHU: return __umulhi(a, b);
    default:    return 0u;                     // NOP
  }
}

// one bit of the 64-bit membership filter per tag (Fibonacci hash)
__device__ __forceinline__ uint64_t bit_of(int t) {
  return 1ull << ((static_cast<uint32_t>(t) * 0x9E3779B1u) >> 26);
}

// --- the K-slot deviation set, in registers ---------------------------------

template <int K>
struct DevSet {
  int tag[K];
  uint32_t val[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < K; ++s) { tag[s] = EMPTY; val[s] = 0u; }
  }

  // a carried set, [K, B] layout; it may hold EMPTY slots between live
  // ones, which upsert fills lowest first, as the reference does
  __device__ __forceinline__ void load(const int32_t* tags,
                                       const int32_t* vals, int lane,
                                       int B) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      tag[s] = tags[s * B + lane];
      val[s] = static_cast<uint32_t>(vals[s * B + lane]);
    }
  }

  // the membership filter: 0 iff the set is empty
  __device__ __forceinline__ uint64_t filter() const {
    uint64_t m = 0ull;
#pragma unroll
    for (int s = 0; s < K; ++s) m |= tag[s] != EMPTY ? bit_of(tag[s]) : 0ull;
    return m;
  }

  // whether any of four tags is in the set
  __device__ __forceinline__ bool has_any(int a, int b, int c, int d) const {
    bool found = false;
#pragma unroll
    for (int s = 0; s < K; ++s)
      found |= tag[s] == a || tag[s] == b || tag[s] == c || tag[s] == d;
    return found;
  }

  // (found, value); tags are unique, so the sum is the matching value
  __device__ __forceinline__ bool lookup(int t, uint32_t& v) const {
    bool found = false;
    uint32_t acc = 0u;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool hit = tag[s] == t;
      found |= hit;
      acc += hit ? val[s] : 0u;
    }
    v = acc;
    return found;
  }

  // update the lowest matching slot, else fill the lowest empty one (the
  // reference's min(where(hit/empty, iota, K))); returns true (overflow)
  // when neither exists
  __device__ __forceinline__ bool upsert(int t, uint32_t v) {
    int hit = K, emp = K;
#pragma unroll
    for (int s = K - 1; s >= 0; --s) {
      if (tag[s] == t) hit = s;
      if (tag[s] == EMPTY) emp = s;
    }
    const int slot = hit < K ? hit : emp;
    if (slot >= K) return true;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s == slot) { tag[s] = t; val[s] = v; }
    }
    return false;
  }

  __device__ __forceinline__ void remove(int t) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (tag[s] == t) tag[s] = EMPTY;
    }
  }
};

// One golden step as packed (ops/taint_cuda.py pack_stream), four int4:
//   r[0] = op | flags << 8 (G_WR, G_LD, G_ST, LOUD, TAKEN), dst, src1,
//          src2
//   r[1] = imm, a, b, ea
//   r[2] = res, st_old, dst_old, memory tag of a golden load or store
//          (nphys + slot(ea), else -1)
//   r[3] = first loud step after this one (n if none), the 64-bit filter
//          probe of the tags the step touches (low, high word), shadow
//          coverage bits
__device__ __forceinline__ void load_step(const int4* stream, int i,
                                          int4 (&r)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) r[q] = __ldg(stream + 4 * i + q);
}

// a lane's fault and setup gathers
struct Fault {
  int kind, entry, cycle, land;
  float shadow_u;
  uint32_t gaf, alt1, alt2, mask;
};

struct Flags {
  bool det, trap, div, esc, ovf;
};

// The full step body (_make_kernel's step): → live after the step.
template <int K, bool MAY_LATCH>
__device__ __forceinline__ bool full_step(const int4 (&r)[4], int i,
                                          const Fault& f, DevSet<K>& set,
                                          Flags& fl, int nphys,
                                          int mem_words) {
  const int idx_mask = nphys - 1;
  const int mw_mask = mem_words - 1;
  const int imask = static_cast<int>(f.mask);
  const int op0 = r[0].x & 0xFF, gflags = r[0].x >> 8;
  const int dstr = r[0].y, s1 = r[0].z, s2 = r[0].w;
  const uint32_t imm0 = static_cast<uint32_t>(r[1].x);
  const bool tk = gflags & TAKEN;
  const uint32_t g_a = r[1].y, g_b = r[1].z, g_ea = r[1].w;
  const uint32_t g_res = r[2].x, g_st_old = r[2].y, g_dst_old = r[2].z;
  const bool g_wr = gflags & G_WR, g_ld = gflags & G_LD;
  const bool g_st = gflags & G_ST;
  const float sc = __int_as_float(r[3].w);
  const bool at_uop = f.entry == i;
  bool ovf_now = false;

  // 1. storage-fault landing (REGFILE), tag masked to the registers
  if (f.kind == KIND_REGFILE && f.cycle == i) {
    const int ftag = f.entry & idx_mask;
    uint32_t v;
    const uint32_t content = set.lookup(ftag, v) ? v : f.gaf;
    ovf_now |= set.upsert(ftag, content ^ f.mask);
  }

  // 2. operand read (latch + IQ index faults)
  int op = op0;
  bool illegal = false;
  if (MAY_LATCH && f.kind == KIND_LATCH_OP && at_uop) {
    const int opv = op0 ^ imask;
    illegal = opv >= N_OPCODES || opv < 0;
    op = min(max(opv, 0), N_OPCODES - 1);
  }
  const uint32_t imm =
      imm0 ^ ((f.kind == KIND_LATCH_IMM && at_uop) ? f.mask : 0u);
  const bool iq1 = f.kind == KIND_IQ_SRC1 && at_uop;
  const bool iq2 = f.kind == KIND_IQ_SRC2 && at_uop;
  uint32_t v1, v2;
  const bool f1 = set.lookup(iq1 ? ((s1 ^ imask) & idx_mask) : s1, v1);
  const bool f2 = set.lookup(iq2 ? ((s2 ^ imask) & idx_mask) : s2, v2);
  const uint32_t a = f1 ? v1 : (iq1 ? f.alt1 : g_a);
  const uint32_t b = f2 ? v2 : (iq2 ? f.alt2 : g_b);

  // 3. execute; shadow-FU detection of an FU result fault
  const bool fu = f.kind == KIND_FU && at_uop;
  const uint32_t eff = alu(op, a, b, imm) ^ (fu ? f.mask : 0u);
  const bool det_now = fu && f.shadow_u < sc;
  const bool is_ld = op == LOAD, is_st = op == STORE;
  const bool is_br = op >= BEQ && op <= BGE;
  const bool writes_op =
      (op >= ADD && op <= REMU) || (op >= FADD && op <= MULHU);

  // 4. memory access (LSQ faults), traps: invalid access, illegal
  // opcode, x86 #DE
  const uint32_t addr =
      eff ^ ((f.kind == KIND_LSQ_ADDR && at_uop) ? f.mask : 0u);
  const bool valid =
      (addr & 3u) == 0u && (addr >> 2) < static_cast<uint32_t>(mem_words);
  const bool div_trap =
      ((op == DIV || op == REM) && bad_signed(a, b)) ||
      ((op == DIVU || op == REMU) && b == 0u);
  const bool trap_now = ((is_ld || is_st) && !valid) || illegal || div_trap;
  const int slot = static_cast<int>(addr >> 2) & mw_mask;
  const int slot_g = static_cast<int>(g_ea >> 2) & mw_mask;
  const int mtag = nphys + slot, gtag = nphys + slot_g;
  const bool same_slot = slot == slot_g;

  // 4a. load value: deviation entry > golden same-slot value > escape
  uint32_t ldval = 0u;
  bool esc_now = false;
  if (is_ld) {
    uint32_t vm;
    const bool fm = set.lookup(mtag, vm);
    const bool golden_here = same_slot && (g_ld || g_st);
    ldval = fm ? vm : (golden_here ? (g_ld ? g_res : g_st_old) : 0u);
    esc_now = valid && !trap_now && !fm && !golden_here;
  }

  // 5. branch resolution
  const bool div_now = (is_br && eff != 0u) != tk;
  const bool live_next = !(det_now || trap_now || div_now || esc_now);

  // 4b. the trial's store, then a golden store the trial missed
  const uint32_t st_data =
      b ^ ((f.kind == KIND_LSQ_DATA && at_uop) ? f.mask : 0u);
  const bool st_t = is_st && valid && live_next;
  if (st_t) {
    if (g_st && same_slot && st_data == g_b) set.remove(mtag);
    else ovf_now |= set.upsert(mtag, st_data);
  }
  if (g_st && live_next && !(st_t && same_slot)) {
    uint32_t vg;
    const uint32_t content_g = set.lookup(gtag, vg) ? vg : g_st_old;
    if (content_g == g_b) set.remove(gtag);
    else ovf_now |= set.upsert(gtag, content_g);
  }

  // 6. writeback (a ROB dest-index fault redirects it), then a golden
  // register write the trial missed
  const bool writes_t = (writes_op || is_ld) && live_next;
  const int wtag = (f.kind == KIND_ROB_DST && at_uop)
                       ? ((dstr ^ imask) & idx_mask) : dstr;
  const bool same_dst = wtag == dstr;
  if (writes_t) {
    const uint32_t result = is_ld ? ldval : eff;
    const uint32_t g_post = g_wr ? g_res : g_dst_old;
    if (same_dst && result == g_post) set.remove(dstr);
    else ovf_now |= set.upsert(wtag, result);
  }
  if (g_wr && live_next && !(writes_t && same_dst)) {
    uint32_t vd;
    const uint32_t content_d = set.lookup(dstr, vd) ? vd : g_dst_old;
    if (content_d == g_res) set.remove(dstr);
    else ovf_now |= set.upsert(dstr, content_d);
  }

  fl.det |= det_now;
  fl.trap |= trap_now;
  fl.div |= div_now;
  fl.esc |= esc_now;
  fl.ovf |= ovf_now;
  return live_next && !ovf_now;
}

struct Params {
  const int32_t* stream;      // [n, 16] golden steps (load_step)
  const int32_t* order;       // [B] lane of each thread, by start step
  const int32_t* kind;        // [B] fault coordinates and setup gathers
  const int32_t* cycle;
  const int32_t* entry;
  const int32_t* bit;
  const float* shadow_u;
  const int32_t* gaf;
  const int32_t* alt1;
  const int32_t* alt2;
  const int32_t* final_state; // [nphys + mem_words] golden final reg|mem
                              // (K1 only)
  const int32_t* tags_in;     // [K, B] carried sets (K2 only)
  const int32_t* vals_in;     // [K, B]
  int32_t* outcome;           // [B] K1: outcome class; K2: det | trap << 1
                              //     | div << 2
  int32_t* escaped;           // [B]
  int32_t* overflow;          // [B]
  int32_t* steps;             // [B] steps each lane ran live
  int32_t* tags_out;          // [K, B]
  int32_t* vals_out;          // [K, B]
  int32_t* counts;            // [2, B] or null: per lane, the quiet
                              // non-landing steps taken with a non-empty
                              // set whose tags truly hit the set (row 0)
                              // and miss it (row 1)
  int n, B, nphys, mem_words, compare_regs;
};

template <int K, bool MAY_LATCH, bool CARRY_SETS>
__global__ void __launch_bounds__(THREADS) taint_fast_kernel(Params p) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = t < p.B;
  const int lane = active ? p.order[t] : 0;
  const int n = p.n;
  const int4* stream = reinterpret_cast<const int4*>(p.stream);

  Fault f;
  f.kind = active ? p.kind[lane] : 0;
  f.cycle = active ? p.cycle[lane] : 0;
  f.entry = active ? p.entry[lane] : 0;
  const int bit = active ? p.bit[lane] : 0;
  f.shadow_u = active ? p.shadow_u[lane] : 2.0f;
  f.gaf = active ? static_cast<uint32_t>(p.gaf[lane]) : 0u;
  f.alt1 = active ? static_cast<uint32_t>(p.alt1[lane]) : 0u;
  f.alt2 = active ? static_cast<uint32_t>(p.alt2[lane]) : 0u;
  // 1 << bit, and 0 outside [0, 32) as the reference's shift gives
  f.mask = (bit >= 0 && bit < 32) ? (1u << bit) : 0u;
  // the step where the fault applies; -1: none (a null lane)
  f.land = f.kind == KIND_REGFILE ? f.cycle
           : (f.kind >= KIND_FU && f.kind <= KIND_LATCH_IMM) ? f.entry : -1;

  DevSet<K> set;
  if (CARRY_SETS && active) set.load(p.tags_in, p.vals_in, lane, p.B);
  else set.clear();
  uint64_t filt = set.filter();
  bool live = active;
  Flags fl = {false, false, false, false, false};
  int lived = n, hits = 0, misses = 0;

  // the warp's stream tile: steps [base, base + TILE) in shared memory,
  // and the next tile's steps in flight into registers, one per thread
  __shared__ int4 tiles[THREADS / 32][TILE][4];
  int4 (*tile)[4] = tiles[threadIdx.x / 32];
  const int wl = threadIdx.x % 32;
  int base = -2 * TILE, nbase = -2 * TILE;
  int4 nx[4];

  // the lane's first step: 0 with a set to carry, else its landing or
  // the first loud step, whichever comes first
  int nxt = n;
  if (n > 0) {
    const int4 w0 = __ldg(stream), w3 = __ldg(stream + 3);
    const int loud0 = ((w0.x >> 8) & LOUD) ? 0 : w3.x;
    nxt = filt ? 0 : min(f.land >= 0 ? f.land : n, loud0);
  }

  for (;;) {
    const int i = __reduce_min_sync(FULL_WARP, live ? nxt : n);
    if (i >= n) break;
    if (i < base || i >= base + TILE) {
      // the next tile if it holds step i, else a fresh load from step i
      // (after a jump); then the tile after it goes in flight
      const bool ahead = i >= nbase && i < nbase + TILE;
      if (!ahead) load_step(stream, min(i + wl, n - 1), nx);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) tile[wl][q] = nx[q];
      __syncwarp();
      base = ahead ? nbase : i;
      nbase = base + TILE;
      load_step(stream, min(nbase + wl, n - 1), nx);
    }
    if (!live || nxt != i) continue;

    const int4* rec = tile[i - base];
    const int4 r0 = rec[0], r3 = rec[3];
    bool full = i == f.land || ((r0.x >> 8) & LOUD);
    if (!full) {
      // quiet, not the landing, and (an empty set only stops on those)
      // a non-empty set: the full body only if the step touches it; the
      // filter rules most steps out, the exact test the rest
      const uint64_t probe = static_cast<uint32_t>(r3.y) |
                             static_cast<uint64_t>(static_cast<uint32_t>(r3.z))
                                 << 32;
      if (filt & probe) {
        const int mt = rec[2].w;
        full = set.has_any(r0.y, r0.z, r0.w, mt >= 0 ? mt : r0.z);
      }
      hits += full;
      misses += !full;
    }
    if (full) {
      const int4 r[4] = {r0, rec[1], rec[2], r3};
      live = full_step<K, MAY_LATCH>(r, i, f, set, fl, p.nphys,
                                     p.mem_words);
      filt = set.filter();
      if (!live) {
        lived = i + 1;
        continue;
      }
    }
    nxt = filt ? i + 1 : min(f.land > i ? f.land : n, r3.x);
  }

  if (!active) return;
  if (CARRY_SETS) {
    // a chunk: the raw flags; the driver resolves convergence and the end
    p.outcome[lane] = (fl.det ? 1 : 0) | (fl.trap ? 2 : 0) | (fl.div ? 4 : 0);
  } else {
    // end classification: a surviving deviation that differs from the
    // golden final state is corruption (memory only without compare_regs)
    bool state_diff = false;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int tg = set.tag[s];
      if (tg != EMPTY && (p.compare_regs || tg >= p.nphys))
        state_diff |= set.val[s] != static_cast<uint32_t>(p.final_state[tg]);
    }
    p.outcome[lane] = fl.det ? DETECTED : fl.trap ? DUE
                      : (fl.div || state_diff) ? SDC : MASKED;
  }
  p.escaped[lane] = fl.esc;
  p.overflow[lane] = fl.ovf;
  p.steps[lane] = lived;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    p.tags_out[s * p.B + lane] = set.tag[s];
    p.vals_out[s * p.B + lane] = static_cast<int32_t>(set.val[s]);
  }
  if (p.counts) {
    p.counts[lane] = hits;
    p.counts[p.B + lane] = misses;
  }
}

// Threads per block: whole warps, as few as keep every SM busy — one warp
// per block until B exceeds a warp per SM, up to THREADS.  A warp's time is
// its serial walk over the steps, so a small batch gains from spreading
// its warps over the SMs, a large one from filling each SM.
int block_threads(int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int per_sm = (B + sms - 1) / sms;
  const int warps = (per_sm + 31) / 32;
  return 32 * (warps < 1 ? 1 : warps > THREADS / 32 ? THREADS / 32 : warps);
}

template <int K, bool CARRY_SETS>
cudaError_t launch(const Params& p, bool may_latch, cudaStream_t stream) {
  const int threads = block_threads(p.B);
  const dim3 grid((p.B + threads - 1) / threads), block(threads);
  if (may_latch)
    taint_fast_kernel<K, true, CARRY_SETS><<<grid, block, 0, stream>>>(p);
  else
    taint_fast_kernel<K, false, CARRY_SETS><<<grid, block, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool CARRY_SETS>
int launch_k(const Params& p, int k, int may_latch, void* cuda_stream) {
  if (p.B <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  switch (k) {
    case 16: return static_cast<int>(launch<16, CARRY_SETS>(p, may_latch, s));
    case 4:  return static_cast<int>(launch<4, CARRY_SETS>(p, may_latch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int taint_fast_launch(
    const int32_t* stream, const int32_t* order, const int32_t* kind,
    const int32_t* cycle, const int32_t* entry, const int32_t* bit,
    const float* shadow_u, const int32_t* gaf, const int32_t* alt1,
    const int32_t* alt2, const int32_t* final_state, int32_t* outcome,
    int32_t* escaped, int32_t* overflow, int32_t* steps, int32_t* tags_out,
    int32_t* vals_out, int32_t* counts, int n, int B, int nphys,
    int mem_words, int k, int compare_regs, int may_latch,
    void* cuda_stream) {
  const Params p{stream, order, kind, cycle, entry, bit, shadow_u, gaf,
                 alt1, alt2, final_state, nullptr, nullptr, outcome,
                 escaped, overflow, steps, tags_out, vals_out, counts, n, B,
                 nphys, mem_words, compare_regs};
  return launch_k<false>(p, k, may_latch, cuda_stream);
}

// K2: one chunk from carried sets; bits = det | trap << 1 | div << 2
extern "C" int taint_chunk_launch(
    const int32_t* stream, const int32_t* order, const int32_t* kind,
    const int32_t* cycle, const int32_t* entry, const int32_t* bit,
    const float* shadow_u, const int32_t* gaf, const int32_t* alt1,
    const int32_t* alt2, const int32_t* tags_in, const int32_t* vals_in,
    int32_t* bits, int32_t* escaped, int32_t* overflow, int32_t* steps,
    int32_t* tags_out, int32_t* vals_out, int32_t* counts, int n, int B,
    int nphys, int mem_words, int k, int may_latch, void* cuda_stream) {
  const Params p{stream, order, kind, cycle, entry, bit, shadow_u, gaf,
                 alt1, alt2, nullptr, tags_in, vals_in, bits, escaped,
                 overflow, steps, tags_out, vals_out, counts, n, B, nphys,
                 mem_words, 1};
  return launch_k<true>(p, k, may_latch, cuda_stream);
}
