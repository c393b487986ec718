// Native sequence packer: the C++ twin of data/datasets.py pack_sequences
// (same greedy fill, same split/truncate semantics, bit-identical output —
// asserted against both packages' Python packers in
// tests/test_torch_native.py). The port's own copy of the reference's
// native/pack.cpp, built at first use by native/_lib.py.
//
// Why native: packing an LM corpus is a per-example Python loop over
// millions of mostly-small documents — interpreter-bound exactly like the
// batch-interleave path. Here it is one pass of memcpy/std::fill over a
// flattened token buffer.
//
// One function serves both phases: with null outputs it only simulates the
// row layout and returns the row count (the caller then allocates); with
// outputs it fills pre-zeroed [rows, seq_len] int32 buffers.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Returns the number of packed rows, or -1 on invalid arguments.
// flat: concatenated tokens of all examples (only read when filling).
// lengths[n]: per-example token counts (entries of 0 are skipped).
// out_tokens/out_segs: pre-zeroed [rows * seq_len] int32, or null to count.
long dmltpu_pack(const int32_t* flat, const long* lengths, long n, long seq_len,
                 int split_long, int32_t* out_tokens, int32_t* out_segs) {
    if (seq_len < 1 || n < 0) return -1;
    const bool filling = out_tokens != nullptr && out_segs != nullptr;
    long row = 0, fill = 0;
    int32_t seg = 0;
    long offset = 0;  // read position in flat

    auto flush = [&]() {
        ++row;
        fill = 0;
        seg = 0;
    };
    auto place = [&](long src, long count) {
        ++seg;
        if (filling) {
            int32_t* trow = out_tokens + row * seq_len;
            int32_t* srow = out_segs + row * seq_len;
            std::memcpy(trow + fill, flat + src, count * sizeof(int32_t));
            std::fill(srow + fill, srow + fill + count, seg);
        }
        fill += count;
    };

    for (long i = 0; i < n; ++i) {
        const long len = lengths[i];
        if (len <= 0) continue;  // mirrors the Python packer's empty-skip
        if (len <= seq_len) {
            if (len > seq_len - fill) flush();
            place(offset, len);
            if (fill == seq_len) flush();
        } else if (split_long) {
            long done = 0;
            while (done < len) {
                if (fill == seq_len) flush();
                const long take = (len - done) < (seq_len - fill) ? (len - done) : (seq_len - fill);
                place(offset + done, take);
                done += take;
            }
        } else {
            if (fill) flush();
            place(offset, seq_len);  // truncate
            flush();
        }
        offset += len;
    }
    if (fill) flush();
    return row;
}

}  // extern "C"
