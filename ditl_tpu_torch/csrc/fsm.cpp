// Token-level DFA table construction for grammar-constrained decoding.
// Walks every (dfa-state, token) pair through the byte-level DFA:
//   out[s][v] = end state after consuming token v's bytes from state s,
//               or -1 the moment any byte transition is dead.
// O(S * V * len) tight loops — the numpy fallback in infer/grammar.py does
// the same walk vectorized per byte position; this is ~10-30x faster on
// 32k-vocab tokenizers and keeps grammar registration interactive.
//
// Plain C ABI for ctypes (ditl_tpu_torch/native/fsm.py) — no pybind11 by design.

#include <cstdint>

extern "C" {

// byte_next: (n_states, 256) row-major int32, -1 = dead.
// blob: all token byte strings concatenated; offsets: (n_tokens + 1) int64.
// out: (n_states, n_tokens) row-major int32.
// Zero-length tokens are emitted as -1 (disallowed): a token that consumes
// no bytes would be a free no-op the grammar can never terminate.
void fsm_token_table(const int32_t* byte_next, int64_t n_states,
                     const uint8_t* blob, const int64_t* offsets,
                     int64_t n_tokens, int32_t* out) {
  for (int64_t s = 0; s < n_states; ++s) {
    int32_t* row = out + s * n_tokens;
    for (int64_t v = 0; v < n_tokens; ++v) {
      const int64_t lo = offsets[v], hi = offsets[v + 1];
      if (lo == hi) {
        row[v] = -1;
        continue;
      }
      int32_t st = (int32_t)s;
      for (int64_t i = lo; i < hi; ++i) {
        st = byte_next[(int64_t)st * 256 + blob[i]];
        if (st < 0) break;
      }
      row[v] = st;
    }
  }
}

}  // extern "C"
