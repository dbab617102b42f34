// Serial golden recorder for one chunk of a window: the per-step streams
// the deviation-set chunk kernel reads.
//
// Counterpart of shrewd_tpu/ops/chunked.py _record_chunk (an XLA scan in
// the JAX package).  In torch it would be a step loop of ~12 launches per
// µop; here one host pass over the chunk, from the chunk's golden boundary
// state, writes the six value streams
//   a, b, ea, res, st_old, dst_old      (uint32[6][n], row-major).
// The chunk-end state is the window's next boundary, which the caller
// holds.  The ALU is the oracle's (shrewd_alu in csrc/shrewd.h), so the
// streams agree with the serial C++ oracle by construction.  Semantics per
// step, as _record_chunk:
//   a = reg[src1], b = reg[src2], ea = alu(op, a, b, imm),
//   slot = (ea >> 2) & (mem_words - 1), st_old = mem[slot],
//   res = LOAD ? st_old : ea, dst_old = reg[dst];
//   STORE writes mem[slot] = b; a step whose wr flag is set writes
//   reg[dst] = res.  The caller passes the wr flags (isa/uops.py
//   writes_dest, the same flags the record carries), so the opcode table
//   is read in one place.
// Built with g++ together with csrc/ (shrewd_tpu_torch/native build()).

#include <cstddef>
#include <cstdint>
#include <vector>

#include "shrewd.h"

extern "C" void shrewd_record_chunk(const TraceView* tr,
                                    const uint32_t* init_reg,
                                    const uint32_t* init_mem,
                                    const uint8_t* wr,
                                    uint32_t* streams) {
  const int32_t n = tr->n;
  const uint32_t mw_mask = static_cast<uint32_t>(tr->mem_words - 1);
  std::vector<uint32_t> reg(init_reg, init_reg + tr->nphys);
  std::vector<uint32_t> mem(init_mem, init_mem + tr->mem_words);
  uint32_t* a_s = streams;
  uint32_t* b_s = streams + n;
  uint32_t* ea_s = streams + 2 * static_cast<size_t>(n);
  uint32_t* res_s = streams + 3 * static_cast<size_t>(n);
  uint32_t* st_old_s = streams + 4 * static_cast<size_t>(n);
  uint32_t* dst_old_s = streams + 5 * static_cast<size_t>(n);
  for (int32_t i = 0; i < n; ++i) {
    const int32_t op = tr->opcode[i];
    const uint32_t a = reg[tr->src1[i]];
    const uint32_t b = reg[tr->src2[i]];
    const uint32_t ea = shrewd_alu(op, a, b, tr->imm[i]);
    const uint32_t slot = (ea >> 2) & mw_mask;
    const uint32_t st_old = mem[slot];
    const uint32_t res = op == OP_LOAD ? st_old : ea;
    a_s[i] = a;
    b_s[i] = b;
    ea_s[i] = ea;
    res_s[i] = res;
    st_old_s[i] = st_old;
    dst_old_s[i] = reg[tr->dst[i]];
    if (op == OP_STORE) mem[slot] = b;
    if (wr[i]) reg[tr->dst[i]] = res;
  }
}
