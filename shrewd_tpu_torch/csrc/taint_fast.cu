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
// for CPU tensors.
//
// What bounds it on an H100: not bytes.  At the flagship shape (n = 4096
// steps, B = 131072 lanes, K = 16) it reads a 16 x n golden stream (256 KiB)
// and 32 B of fault coordinates per lane (4 MiB) and writes 3 words plus a
// K-slot (tag, value) set per lane (18 MiB): ~22 MB, ~7 us at 3.35 TB/s.
// The work is integer: every live lane-step does two K-wide operand
// lookups plus, on the steps that write, K-wide upserts and removals —
// so the 32-bit ALU pipes bound it.  The design keeps that work on-chip:
//   - the K-slot set lives in registers (K is a template parameter and every
//     slot loop is unrolled, so no set access touches local memory);
//   - the golden stream is uniform across lanes: each block stages it in
//     shared memory in column tiles, and every thread reads the same word
//     (a broadcast), so the stream costs one device read per block;
//   - a dead lane (detected, trapped, diverged, escaped or overflowed) is
//     frozen, so it stops doing work;
//   - the loop over all n steps runs inside the thread: it replaces the
//     TPU grid's sequential step axis, and needs no carry between blocks;
//   - the block size follows B (launch()): a chunk wave of a few hundred
//     lanes runs as one-warp blocks, so its warps spread over the SMs
//     instead of sharing a few.
// K2 is the same body over one chunk, so the same per-step work bounds it;
// at a chunk wave (B = 512, S = 65536) each thread walks 65536 dependent
// steps, so one warp's latency, not the card's issue rate, sets its time.
// The TPU kernel's restoring divider, (1, B) layout, S_CHUNK blocks and
// unrolled step groups were Mosaic constraints; here division is native,
// the ALU is a per-lane switch (warp-uniform unless a LATCH_OP fault
// changes a lane's opcode), and floating point is IEEE round-to-nearest
// through __f*_rn with explicit subnormal flush and the canonical NaN
// (build with -fmad=false, never --use_fast_math).
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

constexpr int EMPTY = -1;
constexpr int ROWS = 16;      // 15 golden rows + shadow coverage bits
constexpr int TILE = 256;     // golden-stream columns staged per tile
constexpr int THREADS = 128;

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

struct Params {
  const int32_t* stream;      // [ROWS, n]: op dst src1 src2 imm taken a b
                              // ea res st_old dst_old wr ld st | cov bits
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
  int n, B, nphys, mem_words, compare_regs;
};

template <int K, bool MAY_LATCH, bool CARRY_SETS>
__global__ void __launch_bounds__(THREADS) taint_fast_kernel(Params p) {
  __shared__ int32_t tile[ROWS][TILE];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < p.B;
  const int idx_mask = p.nphys - 1;
  const int mw_mask = p.mem_words - 1;

  const int kind = active ? p.kind[lane] : 0;
  const int cycle = active ? p.cycle[lane] : 0;
  const int entry = active ? p.entry[lane] : 0;
  const int bit = active ? p.bit[lane] : 0;
  const float shadow_u = active ? p.shadow_u[lane] : 2.0f;
  const uint32_t gaf = active ? static_cast<uint32_t>(p.gaf[lane]) : 0u;
  const uint32_t alt1 = active ? static_cast<uint32_t>(p.alt1[lane]) : 0u;
  const uint32_t alt2 = active ? static_cast<uint32_t>(p.alt2[lane]) : 0u;
  // 1 << bit, and 0 outside [0, 32) as the reference's shift gives
  const uint32_t mask = (bit >= 0 && bit < 32) ? (1u << bit) : 0u;
  const int imask = static_cast<int>(mask);

  DevSet<K> set;
  if (CARRY_SETS && active) set.load(p.tags_in, p.vals_in, lane, p.B);
  else set.clear();
  bool live = active;
  bool det = false, trap = false, div = false, esc = false, ovf = false;
  int lived = 0;

  for (int t0 = 0; t0 < p.n; t0 += TILE) {
    const int cols = min(TILE, p.n - t0);
    __syncthreads();
    for (int x = threadIdx.x; x < ROWS * TILE; x += blockDim.x) {
      const int r = x / TILE, c = x % TILE;
      if (c < cols) tile[r][c] = p.stream[r * p.n + t0 + c];
    }
    __syncthreads();

    for (int j = 0; j < cols && live; ++j) {
      const int i = t0 + j;
      const int op0 = tile[0][j], dstr = tile[1][j];
      const int s1 = tile[2][j], s2 = tile[3][j];
      const uint32_t imm0 = static_cast<uint32_t>(tile[4][j]);
      const int tk = tile[5][j];
      const uint32_t g_a = tile[6][j], g_b = tile[7][j];
      const uint32_t g_ea = tile[8][j], g_res = tile[9][j];
      const uint32_t g_st_old = tile[10][j], g_dst_old = tile[11][j];
      const bool g_wr = tile[12][j] != 0, g_ld = tile[13][j] != 0;
      const bool g_st = tile[14][j] != 0;
      const float sc = __int_as_float(tile[15][j]);
      const bool at_uop = entry == i;
      bool ovf_now = false;
      ++lived;

      // 1. storage-fault landing (REGFILE), tag masked to the registers
      if (kind == KIND_REGFILE && cycle == i) {
        const int ftag = entry & idx_mask;
        uint32_t v;
        const uint32_t content = set.lookup(ftag, v) ? v : gaf;
        ovf_now |= set.upsert(ftag, content ^ mask);
      }

      // 2. operand read (latch + IQ index faults)
      int op = op0;
      bool illegal = false;
      if (MAY_LATCH && kind == KIND_LATCH_OP && at_uop) {
        const int opv = op0 ^ imask;
        illegal = opv >= N_OPCODES || opv < 0;
        op = min(max(opv, 0), N_OPCODES - 1);
      }
      const uint32_t imm =
          imm0 ^ ((kind == KIND_LATCH_IMM && at_uop) ? mask : 0u);
      const bool iq1 = kind == KIND_IQ_SRC1 && at_uop;
      const bool iq2 = kind == KIND_IQ_SRC2 && at_uop;
      uint32_t v1, v2;
      const bool f1 = set.lookup(iq1 ? ((s1 ^ imask) & idx_mask) : s1, v1);
      const bool f2 = set.lookup(iq2 ? ((s2 ^ imask) & idx_mask) : s2, v2);
      const uint32_t a = f1 ? v1 : (iq1 ? alt1 : g_a);
      const uint32_t b = f2 ? v2 : (iq2 ? alt2 : g_b);

      // 3. execute; shadow-FU detection of an FU result fault
      const bool fu = kind == KIND_FU && at_uop;
      const uint32_t eff = alu(op, a, b, imm) ^ (fu ? mask : 0u);
      const bool det_now = fu && shadow_u < sc;
      const bool is_ld = op == LOAD, is_st = op == STORE;
      const bool is_br = op >= BEQ && op <= BGE;
      const bool writes_op =
          (op >= ADD && op <= REMU) || (op >= FADD && op <= MULHU);

      // 4. memory access (LSQ faults), traps: invalid access, illegal
      // opcode, x86 #DE
      const uint32_t addr =
          eff ^ ((kind == KIND_LSQ_ADDR && at_uop) ? mask : 0u);
      const bool valid =
          (addr & 3u) == 0u && (addr >> 2) < static_cast<uint32_t>(p.mem_words);
      const bool div_trap =
          ((op == DIV || op == REM) && bad_signed(a, b)) ||
          ((op == DIVU || op == REMU) && b == 0u);
      const bool trap_now = ((is_ld || is_st) && !valid) || illegal || div_trap;
      const int slot = static_cast<int>(addr >> 2) & mw_mask;
      const int slot_g = static_cast<int>(g_ea >> 2) & mw_mask;
      const int mtag = p.nphys + slot, gtag = p.nphys + slot_g;
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
      const bool div_now = (is_br && eff != 0u) != (tk != 0);
      const bool live_next = !(det_now || trap_now || div_now || esc_now);

      // 4b. the trial's store, then a golden store the trial missed
      const uint32_t st_data =
          b ^ ((kind == KIND_LSQ_DATA && at_uop) ? mask : 0u);
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
      const int wtag = (kind == KIND_ROB_DST && at_uop)
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

      det |= det_now;
      trap |= trap_now;
      div |= div_now;
      esc |= esc_now;
      ovf |= ovf_now;
      live = live_next && !ovf_now;
    }
  }

  if (!active) return;
  if (CARRY_SETS) {
    // a chunk: the raw flags; the driver resolves convergence and the end
    p.outcome[lane] = (det ? 1 : 0) | (trap ? 2 : 0) | (div ? 4 : 0);
  } else {
    // end classification: a surviving deviation that differs from the
    // golden final state is corruption (memory only without compare_regs)
    bool state_diff = false;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int t = set.tag[s];
      if (t != EMPTY && (p.compare_regs || t >= p.nphys))
        state_diff |= set.val[s] != static_cast<uint32_t>(p.final_state[t]);
    }
    p.outcome[lane] = det ? DETECTED : trap ? DUE
                      : (div || state_diff) ? SDC : MASKED;
  }
  p.escaped[lane] = esc;
  p.overflow[lane] = ovf;
  p.steps[lane] = lived;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    p.tags_out[s * p.B + lane] = set.tag[s];
    p.vals_out[s * p.B + lane] = static_cast<int32_t>(set.val[s]);
  }
}

// Threads per block: whole warps, as few as keep every SM busy — one warp
// per block until B exceeds a warp per SM, up to THREADS.  A lane's time is
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
    const int32_t* stream, const int32_t* kind, const int32_t* cycle,
    const int32_t* entry, const int32_t* bit, const float* shadow_u,
    const int32_t* gaf, const int32_t* alt1, const int32_t* alt2,
    const int32_t* final_state, int32_t* outcome, int32_t* escaped,
    int32_t* overflow, int32_t* steps, int32_t* tags_out, int32_t* vals_out,
    int n, int B, int nphys, int mem_words, int k, int compare_regs,
    int may_latch, void* cuda_stream) {
  const Params p{stream, kind, cycle, entry, bit, shadow_u, gaf, alt1, alt2,
                 final_state, nullptr, nullptr, outcome, escaped, overflow,
                 steps, tags_out, vals_out, n, B, nphys, mem_words,
                 compare_regs};
  return launch_k<false>(p, k, may_latch, cuda_stream);
}

// K2: one chunk from carried sets; bits = det | trap << 1 | div << 2
extern "C" int taint_chunk_launch(
    const int32_t* stream, const int32_t* kind, const int32_t* cycle,
    const int32_t* entry, const int32_t* bit, const float* shadow_u,
    const int32_t* gaf, const int32_t* alt1, const int32_t* alt2,
    const int32_t* tags_in, const int32_t* vals_in, int32_t* bits,
    int32_t* escaped, int32_t* overflow, int32_t* steps, int32_t* tags_out,
    int32_t* vals_out, int n, int B, int nphys, int mem_words, int k,
    int may_latch, void* cuda_stream) {
  const Params p{stream, kind, cycle, entry, bit, shadow_u, gaf, alt1, alt2,
                 nullptr, tags_in, vals_in, bits, escaped, overflow, steps,
                 tags_out, vals_out, n, B, nphys, mem_words, 1};
  return launch_k<true>(p, k, may_latch, cuda_stream);
}
