// The body of the selection core's kernels (csrc/topk_select.cuh
// select_rows, select_indexed), included inside each kernel's braces: one
// source for both, each kernel compiled from its own text as one function
// (a device function between them, or a parameter moved, changes what the
// existing kernels compile to). The including kernel declares Row, NT, CH
// (template parameters), the SelectParams p, and the epilogue flags kCand
// and kIdx. No include guard: it is included twice.
  using S = Smem<Row, NT>;
  using Entry = typename Staged<Row>::Entry;
  constexpr int kWarps = NT / 32;
  constexpr int kPer = Row::kPerChunk;
  constexpr uint32_t kChunkMask = (1u << kPer) - 1u;
  constexpr int kPasses = Row::kBits == 16 ? 2 : 3;
  constexpr int kShift0 = digit_shift<Row::kBits>(0);
  constexpr uint32_t kZeroBin = Row::kZero >> kShift0;
  constexpr uint32_t kNone = 0xFFFFFFFFu;
  constexpr int kPer0 = kBins0 / NT;
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(16) S s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n;
  const int chunks = (n + kPer - 1) / kPer;
  const uint32_t row_bytes = static_cast<uint32_t>(n) * Row::kElem;
  const int nwords = (n + 31) >> 5;
  uint32_t* fmask = reinterpret_cast<uint32_t*>(dyn + static_cast<size_t>(p.slots) * row_bytes);
  // the indexed epilogue has no fired mask; its pairs follow the stage
  Entry* seg0 = reinterpret_cast<Entry*>(fmask + (kIdx ? 0 : ((nwords + 3) & ~3)));
  Entry* seg = seg0 + warp * p.seg;
  uint2* pairs = reinterpret_cast<uint2*>(seg0 + kWarps * p.seg);

  // the dead bits of this thread's chunks, kept for every row (the indexed
  // epilogue has none)
  uint32_t dm[CH];
  uint32_t nd = 0;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = tid + i * NT;
    if constexpr (kIdx)
      dm[i] = 0u;
    else
      dm[i] = c < chunks ? (p.dead[(c * kPer) >> 5] >> ((c * kPer) & 31)) & kChunkMask : 0u;
    nd += __popc(dm[i]);
  }
  // the indexed epilogue's first column: every row a CTA walks is the same
  // segment (the grid is a multiple of parts); the bias is read through the
  // read-only cache with each row (held in registers it spilled, and ran
  // slower on an H100: 7.2 against 6.0 ms at 48,000 × 20,480 f32)
  const uint32_t col0 = kIdx ? static_cast<uint32_t>(blockIdx.x % idx_parts(p)) * n : 0u;
  const bool fused = kIdx && Row::kBits == 32 && idx_bias(p) != nullptr;
  for (int b = tid; b < 2 * kBins0; b += NT) (&s.h[0][0])[b] = 0u;
  for (int b = tid; b < kMaxSel * S::kLaterBins; b += NT) (&s.g[0][0])[b] = 0u;
  if constexpr (!kIdx)
    for (int w = tid; w < nwords; w += NT) fmask[w] = 0u;
  nd = __reduce_add_sync(kFull, nd);
  if (lane == 0) s.wsum[warp].x = nd;
  if (tid == 0 && p.slots > 0) {
    for (int j = 0; j < p.slots; ++j) hopper::mbar_init(&s.full[j], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  uint32_t n_dead = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_dead += s.wsum[w].x;

  auto issue = [&](int slot, int row) {
    if (row >= p.m) return;
    unsigned char* dst = dyn + static_cast<size_t>(slot) * row_bytes;
    const unsigned char* src =
        static_cast<const unsigned char*>(p.acts) + static_cast<size_t>(row) * row_bytes;
    hopper::mbar_expect_tx(&s.full[slot], row_bytes);
    for (uint32_t off = 0; off < row_bytes; off += kPiece)
      hopper::bulk_load_1d(dst + off, src + off, min(kPiece, row_bytes - off), &s.full[slot]);
  };
  if (tid == 0)
    for (int j = 0; j < p.slots; ++j) issue(j, blockIdx.x + j * gridDim.x);

  // what every row shares: candidates, which selections radix-select, and
  // whether the exact path's edge rule needs a row's smallest key
  bool radix[kMaxSel];
  bool need_min = false;
#pragma unroll
  for (int i = 0; i < kMaxSel; ++i) {
    const uint32_t cand = i == kAux ? n_dead : static_cast<uint32_t>(n);
    radix[i] = i < p.nsel && cand >= p.k[i];
    need_min |= i < p.nsel && !radix[i] && cand > 0;
  }
  const bool need_range = kCand || (!kIdx && Row::kFloat) || need_min;
  // key 0 in the last chunk past n (rows loaded without the ring), live
  const uint32_t pads = static_cast<uint32_t>(chunks * kPer - n);
  // first-digit bins from the last row's buckets, one bin lower: a row
  // stages its keys at or above them (cut_dead for dead columns) and
  // selects from those alone when every k-th key lies there; kNone, or a
  // row whose k-th key lies lower, selects from all the keys it holds
  uint32_t cut_live = kNone, cut_dead = kNone;

  for (int it = 0, row = blockIdx.x; row < p.m; ++it, row += gridDim.x) {
    // ---- the row into registers, as keys
    uint32_t kw[CH][4];
    if (p.slots > 0) {
      const int slot = it % p.slots;
      hopper::mbar_wait(&s.full[slot], (it / p.slots) & 1);
      const uint4* src = reinterpret_cast<const uint4*>(dyn + static_cast<size_t>(slot) * row_bytes);
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = tid + i * NT;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c < chunks) {
          v = src[c];
          if constexpr (kIdx) {
            if constexpr (Row::kBits == 32) {
              if (fused) {
                const float4 b4 = __ldg(reinterpret_cast<const float4*>(idx_bias(p) + col0) + c);
                v = make_uint4(add_relu(v.x, b4.x), add_relu(v.y, b4.y), add_relu(v.z, b4.z),
                               add_relu(v.w, b4.w));
              }
            }
            v = make_uint4(Row::sort_word(v.x), Row::sort_word(v.y), Row::sort_word(v.z),
                           Row::sort_word(v.w));
          } else {
            v = make_uint4(Row::word(v.x), Row::word(v.y), Row::word(v.z), Row::word(v.w));
          }
        }
        kw[i][0] = v.x;
        kw[i][1] = v.y;
        kw[i][2] = v.z;
        kw[i][3] = v.w;
      }
    } else {
      const size_t base = static_cast<size_t>(row) * n;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = tid + i * NT;
        kw[i][0] = kw[i][1] = kw[i][2] = kw[i][3] = 0u;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int j = c * kPer + e;
          if (c < chunks && j < n) {
            if constexpr (kIdx && Row::kBits == 16) {
              const uint32_t raw = static_cast<const uint16_t*>(p.acts)[base + j];
              kw[i][e >> 1] |= Row::sort_key(raw) << (16 * (e & 1));
            } else if constexpr (kIdx) {
              uint32_t raw = static_cast<const uint32_t*>(p.acts)[base + j];
              if (fused) raw = add_relu(raw, __ldg(idx_bias(p) + col0 + j));
              kw[i][e] = Row::sort_key(raw);
            } else if constexpr (Row::kBits == 16) {
              const uint32_t raw = static_cast<const uint16_t*>(p.acts)[base + j];
              kw[i][e >> 1] |= Row::key(raw) << (16 * (e & 1));
            } else {
              kw[i][e] = Row::key(static_cast<const uint32_t*>(p.acts)[base + j]);
            }
          }
        }
      }
    }

    // ---- stage the keys above the cutoffs; the range for the edge rules
    uint32_t staged = kNone;
    if (cut_dead != kNone)
      staged = stage_keys<Row, NT, CH>(kw, dm, cut_live << kShift0, cut_dead << kShift0, seg,
                                       p.seg);
    uint4 cnt = make_uint4(0u, 0u, 0u, 0u);
    uint4 rng = make_uint4(0xFFFFFFFFu, 0u, 0xFFFFFFFFu, 0u);
    if constexpr (kCand && Row::kBits == 16) {
      packed_range<Row, CH>(kw, dm, rng);
      rng = make_uint4(__reduce_min_sync(kFull, rng.x), __reduce_max_sync(kFull, rng.y),
                       __reduce_min_sync(kFull, rng.z), __reduce_max_sync(kFull, rng.w));
    } else if (need_range) {
      key_range<Row, NT, CH>(kw, dm, chunks, cnt, rng);
      cnt = make_uint4(0u, 0u, __reduce_add_sync(kFull, cnt.z), __reduce_add_sync(kFull, cnt.w));
      rng = make_uint4(__reduce_min_sync(kFull, rng.x), __reduce_max_sync(kFull, rng.y),
                       __reduce_min_sync(kFull, rng.z), __reduce_max_sync(kFull, rng.w));
    }
    if (lane == 0) {
      s.staged[warp] = staged;
      s.counts[warp] = cnt;
      s.range[warp] = rng;
    }
    __syncthreads();  // the row is in registers: its buffer takes the next row
    if (tid == 0 && p.slots > 0) issue(it % p.slots, row + p.slots * gridDim.x);
    bool from_stage = cut_dead != kNone;
    uint32_t bottom_all = 0u, bottom_dead = 0u;  // keys 0, padding included
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      from_stage = from_stage && s.staged[w] != kNone;
      if (need_range) {
        const uint4 c = s.counts[w], r = s.range[w];
        bottom_all += c.z;
        bottom_dead += c.w;
        rng = make_uint4(min(rng.x, r.x), max(rng.y, r.y), min(rng.z, r.z), max(rng.w, r.w));
      }
    }

    // ---- first digit: from the staged keys, else (or when a k-th key lies
    // below the cutoffs) from every key held, the zero key counted apart
    uint32_t zc[kMaxSel], prefix[kMaxSel], need[kMaxSel];
    for (int attempt = from_stage ? 0 : 1; attempt < 2; ++attempt) {
      const bool stage_pass = attempt == 0;
      uint32_t zl = 0u, zd = 0u;
      if (stage_pass) {
        each_staged_key<Row>(seg, staged, [&](uint32_t key, uint32_t dead) {
          atomicAdd(&s.h[dead][key >> kShift0], 1u);
        });
      } else {
        each_held_key<Row, NT, CH>(kw, dm, chunks, [&](uint32_t key, uint32_t dead) {
          const uint32_t zero = key == Row::kZero;
          zl += zero & (dead ^ 1u);
          zd += zero & dead;
          if (!zero) atomicAdd(&s.h[dead][key >> kShift0], 1u);
        });
        zl = __reduce_add_sync(kFull, zl);
        zd = __reduce_add_sync(kFull, zd);
        if (lane == 0) s.counts[warp] = make_uint4(zl, zd, 0u, 0u);
      }
      __syncthreads();
      if (tid == 0) {
#pragma unroll
        for (int i = 0; i < kMaxSel; ++i) s.pick[i][0] = kNone;
      }
      if (!stage_pass) {
        zl = zd = 0u;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          zl += s.counts[w].x;
          zd += s.counts[w].y;
        }
      }
      // each selection's zero keys (at kZeroBin), and the padding in bin 0
      // of live keys
      uint32_t padc[kMaxSel];
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        zc[i] = i == kAux ? zd : zl + zd;
        padc[i] = (i == kAux || stage_pass) ? 0u : pads;
      }
      uint32_t all[kPer0], dead[kPer0];
      take_bins<kPer0>(s.h[0], all);
      take_bins<kPer0>(s.h[1], dead);
#pragma unroll
      for (int b = 0; b < kPer0; ++b) all[b] += dead[b];
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) need[i] = p.k[i];
      pick_bins<NT, kPer0>(
          p.nsel, radix, need,
          [&](int i, int b) -> uint32_t {
            const int bin = tid * kPer0 + b;
            uint32_t v = i == kAux ? dead[b] : all[b];
            if (bin == static_cast<int>(kZeroBin)) v += zc[i];
            if (bin == 0) v -= padc[i];
            return v;
          },
          s.wsum, s.pick);
      bool found = true;
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        prefix[i] = s.pick[i][0];
        if (radix[i]) {
          // from the stage, a bin below a cutoff holds only some of its keys
          found = found && prefix[i] != kNone &&
                  (!stage_pass || prefix[i] >= (i == kAux ? cut_dead : cut_live));
          need[i] -= s.pick[i][1];
        }
      }
      from_stage = stage_pass && found;
      if (found) break;
    }
    {  // the next row's cutoffs
      uint32_t lo_live = kBins0;
      if (radix[0]) lo_live = min(lo_live, prefix[0]);
      if (radix[2]) lo_live = min(lo_live, prefix[2]);
      const uint32_t lo_dead = radix[kAux] ? min(lo_live, prefix[kAux]) : lo_live;
      const bool use = lo_dead < kBins0 && lo_dead > kZeroBin + 1u;  // the zero key stays out
      cut_live = use ? lo_live - 1u : kNone;
      cut_dead = use ? lo_dead - 1u : kNone;
      // candidates send every dead key where the row holds fewer than k[1]:
      // the stage keeps them all
      if constexpr (kCand)
        if (use && !radix[kAux]) cut_dead = 0u;
    }

    // ---- later digits, inside each selection's bin
#pragma unroll
    for (int pass = 1; pass < kPasses; ++pass) {
      const int sh = digit_shift<Row::kBits>(pass), wd = digit_width<Row::kBits>(pass);
      const uint32_t dmask = (1u << wd) - 1u;
      const uint32_t zero_top = Row::kZero >> (sh + wd);
      // a selection that does not radix-select matches nothing
      uint32_t match[kMaxSel];
#pragma unroll
      for (int q = 0; q < kMaxSel; ++q) match[q] = radix[q] ? prefix[q] : kNone;
      if (from_stage) {
        each_staged_key<Row>(seg, staged,
                             LaterDigit<Row, S::kLaterBins, false>{match[0], match[1], match[2], sh, wd, &s.g[0][0]});
      } else if (match[0] == zero_top || match[1] == zero_top || match[2] == zero_top) {
        each_held_key<Row, NT, CH>(kw, dm, chunks,
                                   LaterDigit<Row, S::kLaterBins, true>{match[0], match[1], match[2], sh, wd, &s.g[0][0]});
      } else {
        each_held_key<Row, NT, CH>(kw, dm, chunks,
                                   LaterDigit<Row, S::kLaterBins, false>{match[0], match[1], match[2], sh, wd, &s.g[0][0]});
      }
      __syncthreads();
      const uint32_t padl = from_stage ? 0u : pads;
      auto adjust = [&](int i, int bin) -> uint32_t {
        uint32_t c = 0u;
        if (zero_top == prefix[i] && bin == static_cast<int>((Row::kZero >> sh) & dmask))
          c += zc[i];
        if (prefix[i] == 0u && bin == 0) c -= padl * (i != kAux);
        return c;
      };
      if constexpr (Row::kBits == 16) {
#pragma unroll
        for (int q = 0; q < kMaxSel; ++q)
          if (q == warp && q < p.nsel && radix[q]) {
            find_warp(
                q, need[q],
                [&](int i, int b) -> uint32_t { return s.g[i][b] + adjust(i, b); }, s.pick);
            s.g[q][lane] = 0u;
          }
        __syncthreads();
      } else {
        constexpr int kPer1 = kBins0 / NT;
        uint32_t c[kMaxSel][kPer1];
#pragma unroll
        for (int q = 0; q < kMaxSel; ++q) take_bins<kPer1>(s.g[q], c[q]);
        pick_bins<NT, kPer1>(
            p.nsel, radix, need,
            [&](int i, int b) -> uint32_t { return c[i][b] + adjust(i, tid * kPer1 + b); },
            s.wsum, s.pick);
      }
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i)
        if (radix[i]) {
          prefix[i] = (prefix[i] << wd) | s.pick[i][0];
          need[i] -= s.pick[i][1];
        }
    }

    if constexpr (kCand) {
      emit_candidates<Row, NT, CH>(p, row, kw, dm, chunks, radix, prefix, need, rng, n_dead,
                                   from_stage, seg, staged, s.wsum);
      continue;
    }
    if constexpr (kIdx) {
      emit_indexed<Row, NT, CH>(p, row, kw, prefix[0], need[0], col0, s.wsum, pairs);
      continue;
    }

    // ---- thresholds by the edge rules, and the fired test's key
    uint32_t fk;
    if constexpr (Row::kFloat) {
      float tmain = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        if (i >= p.nsel || (i != 0 && tid != i)) continue;
        float vk;  // the k-th largest entry of the masked row
        if (radix[i])
          vk = Row::value(prefix[i]);
        else if (i == kAux && p.k[i] <= static_cast<uint32_t>(n))
          vk = -INFINITY;
        else
          vk = NAN;  // fewer than k entries: count >= k never holds
        const uint32_t lo_key = i == kAux ? rng.z : rng.x;
        float lo = lo_key == 0xFFFFFFFFu ? INFINITY : Row::value(lo_key);
        float hi = i == kAux ? (n_dead > 0 ? Row::value(rng.w) : -INFINITY) : Row::value(rng.y);
        for (int step = 0; step < p.iters; ++step) {
          const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
          if (mid <= vk)
            lo = mid;
          else
            hi = mid;
        }
        if (tid == i) p.t[i][row] = lo;
        if (i == 0) tmain = lo;
      }
      fk = max(Row::fire_key(tmain), Row::kZero + 1u);
    } else {
      uint32_t out[kMaxSel];
#pragma unroll
      for (int i = 0; i < kMaxSel; ++i) {
        const uint32_t cand = i == kAux ? n_dead : static_cast<uint32_t>(n);
        const uint32_t bottom = i == kAux ? bottom_dead : bottom_all - pads;  // real keys 0
        const uint32_t smallest = bottom > 0 ? 0u : (i == kAux ? rng.z : rng.x);
        out[i] = radix[i] ? prefix[i] : (cand == 0 ? Row::kInf : smallest);
      }
      if (tid < p.nsel) {
#pragma unroll
        for (int i = 0; i < kMaxSel; ++i)
          if (i == tid) p.t[i][row] = Row::value(out[i]);
      }
      fk = max(out[0], Row::kZero + 1u);  // >= t_main and positive
    }

    // ---- fired: a chunk's selected columns into one word of the mask
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      uint32_t bits = 0u;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        bits |= static_cast<uint32_t>(key_at<Row, CH>(kw, i, e) >= fk) << e;
      if (bits) {
        const int col = (tid + i * NT) * kPer;
        atomicOr(&fmask[col >> 5], bits << (col & 31));
      }
    }
  }
  if constexpr (!kCand && !kIdx) {
    __syncthreads();
    for (int w = tid; w < nwords; w += NT)
      if (fmask[w]) atomicOr(&p.fired[w], fmask[w]);
  }
