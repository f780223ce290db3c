// Native terrain runtime: residency state machine + async tile file IO.
//
// The reference implements its host runtime in Rust: the TileAtlas
// residency state machine (request counting, FIFO-of-unused-slots LRU,
// best-loaded-ancestor walks; reference src/terrain_data/tile_atlas.rs:282-504)
// and the async tile file loader (AsyncComputeTaskPool tasks,
// tile_atlas.rs:77-149). This is its C++ equivalent for the PyTorch
// package, a copy of the JAX package's runtime, exposed through a C ABI
// consumed via ctypes (bevy_terrain_tpu_torch/native/__init__.py); the
// Python implementation remains as a semantically identical fallback
// (BT_DISABLE_NATIVE=1) and as the cross-check oracle in tests.
//
// Tile keys are the packed int64 of terrain_data/tile_atlas.py::pack_keys:
//   side << 57 | lod << 52 | x << 26 | y        (lod <= 26)
//
// Build: bevy_terrain_tpu_torch/native/__init__.py compiles it with g++ at
// first use into build/native/ (its flags: native.CXXFLAGS).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int64_t kLodShift = 52;
constexpr int64_t kXShift = 26;
constexpr int64_t kSideShift = 57;
constexpr int32_t kInvalid = -1;

inline int64_t parent_key(int64_t key) {
  const int64_t side = key >> kSideShift;
  const int64_t lod = (key >> kLodShift) & 0x1F;
  const int64_t x = (key >> kXShift) & 0x3FFFFFF;
  const int64_t y = key & 0x3FFFFFF;
  if (lod == 0) return -1;
  return (side << kSideShift) | ((lod - 1) << kLodShift) | ((x >> 1) << kXShift) |
         (y >> 1);
}

struct TileState {
  int32_t atlas_index = kInvalid;
  int32_t requests = 0;
  int32_t loading_remaining = 0;  // 0 == Loaded
};

struct LoadEntry {
  int64_t key;
  int32_t atlas_index;
  int32_t attachment_index;
};

// Residency state machine (tile_atlas.rs:282-504 semantics).
struct Residency {
  int32_t atlas_size;
  int32_t attachment_count;
  struct UnusedEntry {
    int32_t index;
    uint32_t generation;
    int64_t key;
  };

  std::unordered_map<int64_t, TileState> states;
  // FIFO of unused slots == LRU cache (tile_atlas.rs:506-515). Entries are
  // invalidated lazily via per-slot generation counters (revival removes a
  // slot from the cache, tile_atlas.rs:426-431; re-release re-queues it at
  // the back with a fresh generation).
  std::deque<UnusedEntry> unused;
  std::vector<uint32_t> generation;
  std::unordered_set<int64_t> existing;
  std::deque<LoadEntry> to_load;
  int64_t release_underflows = 0;

  Residency(int32_t size, int32_t attachments)
      : atlas_size(size), attachment_count(attachments), generation(size, 0) {
    for (int32_t i = 0; i < size; ++i) unused.push_back({i, 0, INT64_MIN});
  }

  // pops the least-recently-released slot (tile_atlas.rs:383-389);
  // returns -1 on exhaustion ("Atlas out of indices", tile_atlas.rs:384)
  int32_t allocate() {
    while (!unused.empty()) {
      const UnusedEntry e = unused.front();
      unused.pop_front();
      if (e.generation != generation[e.index]) continue;  // stale entry
      generation[e.index] += 1;  // consumed
      if (e.key != INT64_MIN) states.erase(e.key);
      return e.index;
    }
    return kInvalid;
  }

  // returns atlas_index, or -2 when the tile doesn't exist, or -3 on
  // atlas exhaustion (tile_atlas.rs:418-457)
  int32_t request(int64_t key) {
    if (!existing.count(key)) return -2;
    auto it = states.find(key);
    if (it != states.end()) {
      TileState &s = it->second;
      if (s.requests == 0) generation[s.atlas_index] += 1;  // revive from LRU
      s.requests += 1;
      return s.atlas_index;
    }
    const int32_t index = allocate();
    if (index == kInvalid) return -3;
    TileState s;
    s.atlas_index = index;
    s.requests = 1;
    s.loading_remaining = attachment_count;
    states.emplace(key, s);
    for (int32_t a = 0; a < attachment_count; ++a)
      to_load.push_back({key, index, a});
    return index;
  }

  // returns 0, or -1 for releasing a non-present tile (panic in the
  // reference, tile_atlas.rs:467), or -2 for over-releasing a cached
  // tile (the reference underflows its u32 refcount there in release
  // builds; guarded + counted here instead)
  int32_t release(int64_t key) {
    if (!existing.count(key)) return 0;
    auto it = states.find(key);
    if (it == states.end()) return -1;
    TileState &s = it->second;
    if (s.requests == 0) {
      release_underflows += 1;
      return -2;
    }
    s.requests -= 1;
    if (s.requests == 0)
      unused.push_back({s.atlas_index, generation[s.atlas_index], key});
    return 0;
  }

  // one attachment finished loading; returns -1 on over-load (panic in the
  // reference, tile_atlas.rs:355-357)
  int32_t loaded(int64_t key) {
    auto it = states.find(key);
    if (it == states.end()) return 0;  // tile already evicted
    if (it->second.loading_remaining == 0) return -1;
    it->second.loading_remaining -= 1;
    return 0;
  }

  int32_t get_or_allocate(int64_t key) {
    existing.insert(key);
    auto it = states.find(key);
    if (it != states.end()) return it->second.atlas_index;
    const int32_t index = allocate();
    if (index == kInvalid) return -3;
    TileState s;
    s.atlas_index = index;
    s.requests = 1;
    s.loading_remaining = 0;  // Loaded immediately (tile_atlas.rs:391-416)
    states.emplace(key, s);
    return index;
  }

  // batch best-loaded-ancestor walk (tile_atlas.rs:477-503)
  void best_tiles(const int32_t *side, const int32_t *lod, const int32_t *x,
                  const int32_t *y, int64_t n, int32_t *out_index,
                  int32_t *out_lod) const {
    for (int64_t i = 0; i < n; ++i) {
      int64_t s = side[i], l = lod[i], xx = x[i], yy = y[i];
      out_index[i] = kInvalid;
      out_lod[i] = kInvalid;
      if (l < 0 || xx < 0 || yy < 0 || l > 26) continue;
      while (l >= 0) {
        const int64_t key = (s << kSideShift) | (l << kLodShift) |
                            (xx << kXShift) | yy;
        auto it = states.find(key);
        if (it != states.end() && it->second.loading_remaining == 0) {
          out_index[i] = it->second.atlas_index;
          out_lod[i] = static_cast<int32_t>(l);
          break;
        }
        --l;
        xx >>= 1;
        yy >>= 1;
      }
    }
  }
};

// Async file loader pool (tile_atlas.rs:118-149 equivalent): worker threads
// read whole files into caller-owned buffers; completions are polled.
struct IoPool {
  struct Job {
    int64_t id;
    std::string path;
    uint8_t *buffer;
    int64_t capacity;
  };
  struct Done {
    int64_t id;
    int64_t bytes;  // -1 == error (missing file etc.)
  };

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Job> jobs;
  std::deque<Done> done;
  bool stop = false;

  explicit IoPool(int threads) {
    for (int i = 0; i < threads; ++i)
      workers.emplace_back([this] { this->run(); });
  }

  ~IoPool() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv.notify_all();
    for (auto &w : workers) w.join();
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [this] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop_front();
      }
      int64_t bytes = -1;
      FILE *f = std::fopen(job.path.c_str(), "rb");
      if (f) {
        bytes = static_cast<int64_t>(
            std::fread(job.buffer, 1, static_cast<size_t>(job.capacity), f));
        std::fclose(f);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        done.push_back({job.id, bytes});
      }
    }
  }

  void submit(int64_t id, const char *path, uint8_t *buffer, int64_t capacity) {
    {
      std::lock_guard<std::mutex> lock(mu);
      jobs.push_back({id, path, buffer, capacity});
    }
    cv.notify_one();
  }

  int64_t poll(int64_t *ids, int64_t *sizes, int64_t cap) {
    std::lock_guard<std::mutex> lock(mu);
    int64_t n = 0;
    while (n < cap && !done.empty()) {
      ids[n] = done.front().id;
      sizes[n] = done.front().bytes;
      done.pop_front();
      ++n;
    }
    return n;
  }
};

}  // namespace
namespace {

// ---------------------------------------------------------------------------
// Per-frame request scan (the reference's TileTree::update CPU hot loop,
// tile_tree.rs:268-333). The vectorized-numpy twin pays interpreter
// overhead per call at 320-2000 slots; this runs the same f64 math in a
// plain loop. Cube-sphere math ported from math/coordinate.py
// (C_SQR sigmoid inverse + SIDE_LOCAL_MATRICES, coordinate.rs:110-124).
// ---------------------------------------------------------------------------

constexpr double kCSqr = 0.87 * 0.87;

// cube = SIDE_LOCAL_MATRICES[side] @ [p.x, p.y, 1]
constexpr double kSideMats[6][3][3] = {
    {{0, 0, -1}, {0, -1, 0}, {1, 0, 0}},  {{1, 0, 0}, {0, -1, 0}, {0, 0, 1}},
    {{1, 0, 0}, {0, 0, 1}, {0, 1, 0}},    {{0, 0, 1}, {-1, 0, 0}, {0, 1, 0}},
    {{0, 1, 0}, {-1, 0, 0}, {0, 0, -1}},  {{0, 1, 0}, {0, 0, -1}, {1, 0, 0}},
};

inline int64_t pack_key(int64_t side, int64_t lod, int64_t x, int64_t y) {
  return (side << kSideShift) | (lod << kLodShift) | (x << kXShift) | y;
}

struct ScanParams {
  int32_t kind;        // 0 planar, 1 spherical/ellipsoidal
  double m[12];        // world_from_local (3x4 row-major, f64)
  double inv_m3[9];    // inverse of the 3x3 block (row-major)
  double view[3];
  double approx_height;
  double load_distance;
};

}  // namespace

namespace {

// world position of a slot sample coordinate + approx-height normal offset
// (tile_tree.py::_slot_world_positions). Returns false for NaN (wrapped
// coordinates beyond the per-lod count -> never requested).
inline bool slot_world(const ScanParams &p, int32_t side, double u, double v,
                       double out[3]) {
  double local[3];
  double ln[3];  // local normal
  if (p.kind == 0) {
    local[0] = u - 0.5;
    local[1] = 0.0;
    local[2] = v - 0.5;
    ln[0] = 0.0;
    ln[1] = 1.0;
    ln[2] = 0.0;
  } else {
    // sigmoid_warp_inverse: w = 2uv-1; p = w / sqrt(1 + C - C w^2)
    const double wu = 2.0 * u - 1.0, wv = 2.0 * v - 1.0;
    const double du = 1.0 + kCSqr - kCSqr * wu * wu;
    const double dv = 1.0 + kCSqr - kCSqr * wv * wv;
    if (du <= 0.0 || dv <= 0.0) return false;  // numpy path yields NaN
    const double pu = wu / std::sqrt(du), pv = wv / std::sqrt(dv);
    const double homo[3] = {pu, pv, 1.0};
    double norm2 = 0.0;
    for (int i = 0; i < 3; ++i) {
      local[i] = 0.0;
      for (int j = 0; j < 3; ++j) local[i] += kSideMats[side][i][j] * homo[j];
      norm2 += local[i] * local[i];
    }
    const double inv = 1.0 / std::sqrt(norm2);
    for (int i = 0; i < 3; ++i) {
      local[i] *= inv;
      ln[i] = local[i];
    }
  }
  // world = local @ m3^T + t;  n = normalize(ln @ inv_m3) (row-vector form)
  double n[3] = {0, 0, 0};
  double nn = 0.0;
  for (int j = 0; j < 3; ++j) {
    for (int i = 0; i < 3; ++i) n[j] += ln[i] * p.inv_m3[3 * i + j];
  }
  for (int j = 0; j < 3; ++j) nn += n[j] * n[j];
  nn = 1.0 / std::sqrt(nn);
  for (int j = 0; j < 3; ++j) {
    const double w = p.m[4 * j + 0] * local[0] + p.m[4 * j + 1] * local[1] +
                     p.m[4 * j + 2] * local[2] + p.m[4 * j + 3];
    out[j] = w + p.approx_height * n[j] * nn;
  }
  return true;
}

}  // namespace

extern "C" {

// Scan all (side, lod, i, j) slots: wrap coordinates around the per-lod
// origin, classify requested by closest-point distance, diff against the
// previous state into packed-key release/request lists. Mutates tile_xy
// (S*L*T*T*2 i64) and requested (S*L*T*T u8) in place; returns counts via
// n_released/n_requested. Semantics identical to the numpy scan
// (tile_tree.py::compute_requests); fuzz-tested against it.
void tr_scan_requests(int32_t kind, const double *m, const double *inv_m3,
                      const double *view, double approx_height,
                      double load_distance, int32_t S, int32_t L, int32_t T,
                      const int32_t *origins, const int32_t *view_int,
                      const double *view_frac, int64_t *tile_xy,
                      uint8_t *requested, int64_t *released,
                      int64_t *requested_keys, int32_t *n_released,
                      int32_t *n_requested) {
  ScanParams p;
  p.kind = kind;
  std::memcpy(p.m, m, sizeof(p.m));
  std::memcpy(p.inv_m3, inv_m3, sizeof(p.inv_m3));
  std::memcpy(p.view, view, sizeof(p.view));
  p.approx_height = approx_height;
  p.load_distance = load_distance;
  int32_t nr = 0, nq = 0;
  for (int32_t s = 0; s < S; ++s) {
    for (int32_t l = 0; l < L; ++l) {
      const int64_t sl = (int64_t)s * L + l;
      const int32_t ox = origins[2 * sl], oy = origins[2 * sl + 1];
      const int64_t vix = view_int[2 * sl], viy = view_int[2 * sl + 1];
      const double vfx = view_frac[2 * sl], vfy = view_frac[2 * sl + 1];
      const double inv_count = 1.0 / (double)(int64_t(1) << l);
      const double ld = load_distance * inv_count;
      for (int32_t i = 0; i < T; ++i) {    // x index
        for (int32_t j = 0; j < T; ++j) {  // y index
          const int64_t slot = (sl * T + i) * T + j;
          // wrapping rule: origin + ((ij - origin) mod T)
          const int64_t nx = ox + ((((int64_t)i - ox) % T) + T) % T;
          const int64_t ny = oy + ((((int64_t)j - oy) % T) + T) % T;
          // closest-point offset (tile_tree.rs:199-214)
          const int64_t tox = vix - nx, toy = viy - ny;
          const double offx = tox < 0 ? 0.0 : (tox > 0 ? 1.0 : vfx);
          const double offy = toy < 0 ? 0.0 : (toy > 0 ? 1.0 : vfy);
          const double u = ((double)nx + offx) * inv_count;
          const double v = ((double)ny + offy) * inv_count;
          double w[3];
          bool finite = slot_world(p, s, u, v, w);
          bool new_req = (l == 0);
          if (!new_req && finite) {
            const double dx = w[0] - p.view[0], dy = w[1] - p.view[1],
                         dz = w[2] - p.view[2];
            new_req = std::sqrt(dx * dx + dy * dy + dz * dz) < ld;
          }
          const int64_t old_x = tile_xy[2 * slot], old_y = tile_xy[2 * slot + 1];
          const bool was_req = requested[slot] != 0;
          const bool changed = (nx != old_x) || (ny != old_y);
          if (changed && was_req)
            released[nr++] = pack_key(s, l, old_x, old_y);
          if (!changed && was_req && !new_req)
            released[nr++] = pack_key(s, l, nx, ny);
          if (new_req && (changed || !was_req))
            requested_keys[nq++] = pack_key(s, l, nx, ny);
          tile_xy[2 * slot] = nx;
          tile_xy[2 * slot + 1] = ny;
          requested[slot] = new_req ? 1 : 0;
        }
      }
    }
  }
  *n_released = nr;
  *n_requested = nq;
}

void *tr_residency_create(int32_t atlas_size, int32_t attachment_count) {
  return new Residency(atlas_size, attachment_count);
}

void tr_residency_destroy(void *r) { delete static_cast<Residency *>(r); }

void tr_add_existing(void *r, const int64_t *keys, int64_t n) {
  auto *res = static_cast<Residency *>(r);
  for (int64_t i = 0; i < n; ++i) res->existing.insert(keys[i]);
}

void tr_clear_existing(void *r) {
  static_cast<Residency *>(r)->existing.clear();
}

int64_t tr_existing_count(void *r) {
  return static_cast<int64_t>(static_cast<Residency *>(r)->existing.size());
}

int32_t tr_request(void *r, int64_t key) {
  return static_cast<Residency *>(r)->request(key);
}

int32_t tr_release(void *r, int64_t key) {
  return static_cast<Residency *>(r)->release(key);
}

int64_t tr_release_underflows(void *r) {
  return static_cast<Residency *>(r)->release_underflows;
}

int32_t tr_loaded(void *r, int64_t key) {
  return static_cast<Residency *>(r)->loaded(key);
}

int32_t tr_get_or_allocate(void *r, int64_t key) {
  return static_cast<Residency *>(r)->get_or_allocate(key);
}

// Pop up to `cap` pending load entries into parallel output arrays.
int64_t tr_drain_loads(void *r, int64_t *keys, int32_t *indices,
                       int32_t *attachments, int64_t cap) {
  auto *res = static_cast<Residency *>(r);
  int64_t n = 0;
  while (n < cap && !res->to_load.empty()) {
    const LoadEntry &e = res->to_load.front();
    keys[n] = e.key;
    indices[n] = e.atlas_index;
    attachments[n] = e.attachment_index;
    res->to_load.pop_front();
    ++n;
  }
  return n;
}

void tr_best_tiles(void *r, const int32_t *side, const int32_t *lod,
                   const int32_t *x, const int32_t *y, int64_t n,
                   int32_t *out_index, int32_t *out_lod) {
  static_cast<Residency *>(r)->best_tiles(side, lod, x, y, n, out_index, out_lod);
}

int32_t tr_index_of(void *r, int64_t key) {
  auto *res = static_cast<Residency *>(r);
  auto it = res->states.find(key);
  return it == res->states.end() ? kInvalid : it->second.atlas_index;
}

int32_t tr_requests_of(void *r, int64_t key) {
  auto *res = static_cast<Residency *>(r);
  auto it = res->states.find(key);
  return it == res->states.end() ? -1 : it->second.requests;
}

int64_t tr_resident_count(void *r) {
  return static_cast<int64_t>(static_cast<Residency *>(r)->states.size());
}

// Separable clamp-to-edge bilinear resize of a (H, W, C) f32 source to a
// (B, P, C) band (split.wgsl:28-33 semantics), threaded over output rows.
// Accumulation order matches the numpy host path bit-for-bit: the y-pass
// intermediate is rounded to f32 before the x-pass, each tap pair sums as
// fl(fl(w0*s0) + fl(w1*s1)) (the build disables fp contraction), and
// tap weights use the same f64 math with a final f32 round.
static inline void tap(const double *pos, int64_t i, int64_t size,
                       int64_t &i0, int64_t &i1, float &w0, float &w1) {
  double p = pos[i];
  if (p < 0.0) p = 0.0;
  const double hi = static_cast<double>(size - 1);
  if (p > hi) p = hi;
  i0 = static_cast<int64_t>(std::floor(p));
  i1 = i0 + 1 < size ? i0 + 1 : size - 1;
  const double f = p - static_cast<double>(i0);
  w0 = static_cast<float>(1.0 - f);
  w1 = static_cast<float>(f);
}

void tr_split_bilinear(const float *src, int64_t H, int64_t W, int64_t C,
                       const double *px, int64_t P, const double *py,
                       int64_t B, float *out) {
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 16) n_threads = 16;
  if (B < n_threads) n_threads = static_cast<int>(B);
  std::vector<std::thread> workers;
  std::atomic<int64_t> next_row{0};
  auto worker = [&]() {
    std::vector<float> band(static_cast<size_t>(W) * C);
    for (;;) {
      const int64_t r = next_row.fetch_add(1);
      if (r >= B) return;
      int64_t y0, y1;
      float wy0, wy1;
      tap(py, r, H, y0, y1, wy0, wy1);
      const float *s0 = src + y0 * W * C;
      const float *s1 = src + y1 * W * C;
      for (int64_t i = 0; i < W * C; ++i) {
        const float a = wy0 * s0[i];
        const float b = wy1 * s1[i];
        band[i] = a + b;
      }
      float *o = out + r * P * C;
      for (int64_t k = 0; k < P; ++k) {
        int64_t x0, x1;
        float wx0, wx1;
        tap(px, k, W, x0, x1, wx0, wx1);
        const float *b0 = band.data() + x0 * C;
        const float *b1 = band.data() + x1 * C;
        for (int64_t c = 0; c < C; ++c) {
          const float a = wx0 * b0[c];
          const float b = wx1 * b1[c];
          o[k * C + c] = a + b;
        }
      }
    }
  };
  for (int i = 0; i < n_threads; ++i) workers.emplace_back(worker);
  for (auto &w : workers) w.join();
}

void *tr_io_create(int32_t threads) { return new IoPool(threads); }

void tr_io_destroy(void *p) { delete static_cast<IoPool *>(p); }

void tr_io_submit(void *p, int64_t id, const char *path, uint8_t *buffer,
                  int64_t capacity) {
  static_cast<IoPool *>(p)->submit(id, path, buffer, capacity);
}

int64_t tr_io_poll(void *p, int64_t *ids, int64_t *sizes, int64_t cap) {
  return static_cast<IoPool *>(p)->poll(ids, sizes, cap);
}

// ---------------------------------------------------------------------------
// Per-view second-order Taylor series of the cube-sphere surface
// (math/approximation.py::TerrainModelApproximation.compute, the behavioral
// twin of the reference's terrain_model.rs:263-360 analytic chain). The
// vectorized-numpy version pays small-array overhead; this is the same f64
// math as scalar loops over the 6 sides.
//
// Inputs: uv (6x2 f64, view uv already projected onto every side), view
// world position (3 f64), m = world_from_local (3x4 row-major f64),
// origin_count = 2^origin_lod. Outputs: origin_xy (6x2 i32), origin_uv
// (6x2 f32), coeffs (6 coeff kinds x 6 sides x 3 f32) ordered
// c, c_s, c_t, c_ss (pre-halved), c_st, c_tt (pre-halved).
// ---------------------------------------------------------------------------

void tr_taylor_spherical(const double *uv, const double *view, const double *m,
                         double origin_count, int32_t *origin_xy,
                         float *origin_uv, float *coeffs) {
  // SIDE_MATRICES (approximation.py:23-35): shuffle the (a, b, c) basis
  // into cube xyz, column-major source -> stored here row-major.
  static constexpr double kTaylorMats[6][3][3] = {
      {{-1, 0, 0}, {0, 0, -1}, {0, 1, 0}},
      {{0, 1, 0}, {0, 0, -1}, {1, 0, 0}},
      {{0, 1, 0}, {1, 0, 0}, {0, 0, 1}},
      {{1, 0, 0}, {0, -1, 0}, {0, 0, 1}},
      {{0, 0, 1}, {0, -1, 0}, {-1, 0, 0}},
      {{0, 0, 1}, {-1, 0, 0}, {0, 1, 0}},
  };
  for (int side = 0; side < 6; ++side) {
    const double s = uv[2 * side + 0], t = uv[2 * side + 1];
    for (int k = 0; k < 2; ++k) {
      const double scaled = uv[2 * side + k] * origin_count;
      origin_xy[2 * side + k] = static_cast<int32_t>(static_cast<int64_t>(scaled));
      double r = std::fmod(scaled, 1.0);
      if (r < 0.0) r += 1.0;  // numpy % semantics
      origin_uv[2 * side + k] = static_cast<float>(r);
    }

    // u(s) = (2s-1)/sqrt(1-4Cs(s-1)), v(t) likewise, + derivatives
    const double ud = std::sqrt(1.0 - 4.0 * kCSqr * s * (s - 1.0));
    const double u = (2.0 * s - 1.0) / ud;
    const double u_ds = 2.0 * (kCSqr + 1.0) / (ud * ud * ud);
    const double u_dss =
        12.0 * kCSqr * (kCSqr + 1.0) * (2.0 * s - 1.0) / (ud * ud * ud * ud * ud);
    const double vd = std::sqrt(1.0 - 4.0 * kCSqr * t * (t - 1.0));
    const double v = (2.0 * t - 1.0) / vd;
    const double v_dt = 2.0 * (kCSqr + 1.0) / (vd * vd * vd);
    const double v_dtt =
        12.0 * kCSqr * (kCSqr + 1.0) * (2.0 * t - 1.0) / (vd * vd * vd * vd * vd);

    // l = sqrt(1 + u^2 + v^2) and derivatives
    const double l = std::sqrt(1.0 + u * u + v * v);
    const double l3 = l * l * l;
    const double l_ds = u * u_ds / l;
    const double l_dt = v * v_dt / l;
    const double l_dss = (u * u_dss * l * l + (v * v + 1.0) * u_ds * u_ds) / l3;
    const double l_dst = -(u * v * u_ds * v_dt) / l3;
    const double l_dtt = (v * v_dtt * l * l + (u * u + 1.0) * v_dt * v_dt) / l3;

    // quotient-rule chains for (a, b, c) = (1, u, v)/l scaled by powers of l
    const double abc[6][3] = {
        {1.0, u, v},  // value (power 1)
        {-l_ds, -u * l_ds + l * u_ds, -v * l_ds},  // d/ds (power 2)
        {-l_dt, -u * l_dt, -v * l_dt + l * v_dt},  // d/dt (power 2)
        {2.0 * l_ds * l_ds - l * l_dss,
         2.0 * u * l_ds * l_ds - l * (2.0 * u_ds * l_ds + u * l_dss) +
             u_dss * l * l,
         2.0 * v * l_ds * l_ds - l * v * l_dss},  // d2/ds2 (power 3)
        {2.0 * l_ds * l_dt - l * l_dst,
         2.0 * u * l_ds * l_dt - l * (u_ds * l_dt + u * l_dst),
         2.0 * v * l_ds * l_dt - l * (v_dt * l_ds + v * l_dst)},  // d2/dsdt
        {2.0 * l_dt * l_dt - l * l_dtt,
         2.0 * u * l_dt * l_dt - l * u * l_dtt,
         2.0 * v * l_dt * l_dt - l * (2.0 * v_dt * l_dt + v * l_dtt) +
             v_dtt * l * l},  // d2/dt2 (power 3)
    };
    static constexpr int kPower[6] = {1, 2, 2, 3, 3, 3};
    static constexpr double kScale[6] = {1.0, 1.0, 1.0, 0.5, 1.0, 0.5};
    for (int k = 0; k < 6; ++k) {
      double rot[3];
      for (int i = 0; i < 3; ++i) {
        rot[i] = kTaylorMats[side][i][0] * abc[k][0] +
                 kTaylorMats[side][i][1] * abc[k][1] +
                 kTaylorMats[side][i][2] * abc[k][2];
      }
      double inv = 1.0;
      for (int p = 0; p < kPower[k]; ++p) inv /= l;
      for (int i = 0; i < 3; ++i) rot[i] *= inv;
      for (int i = 0; i < 3; ++i) {
        double w = m[4 * i + 0] * rot[0] + m[4 * i + 1] * rot[1] +
                   m[4 * i + 2] * rot[2];
        if (k == 0) w += m[4 * i + 3] - view[i];  // c = p - view
        coeffs[(k * 6 + side) * 3 + i] = static_cast<float>(kScale[k] * w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Full Taylor entry for TRUE spheres: world view position -> cube-sphere
// coordinate (coordinate.py::Coordinate.from_world_position, the twin of
// coordinate.rs:69-108) -> projection onto all 6 faces
// (project_uv_to_side, coordinate.rs:134-151) -> derivative chain above.
// Ellipsoids keep the host bisection projector and call tr_taylor_spherical
// with precomputed uv. lm = local_from_world (3x4 row-major f64).
// ---------------------------------------------------------------------------

// Spherical view coordinate projected onto all 6 faces: world -> unit
// local -> face pick + sigmoid warp (coordinate.rs:69-108) -> per-face
// projection (coordinate.rs:134-151). Shared by the Taylor entry and the
// per-frame view-anchor computation (ops/tile_tree.py::compute_view_anchors).
void tr_project_view_uv(const double *view, const double *lm, double *uv6) {
  double local[3];
  for (int i = 0; i < 3; ++i) {
    local[i] = lm[4 * i + 0] * view[0] + lm[4 * i + 1] * view[1] +
               lm[4 * i + 2] * view[2] + lm[4 * i + 3];
  }
  const double inv = 1.0 / std::sqrt(local[0] * local[0] + local[1] * local[1] +
                                     local[2] * local[2]);
  for (int i = 0; i < 3; ++i) local[i] *= inv;

  // face pick (coordinate.py::pick_cube_face, coordinate.rs:76-94)
  const double x = local[0], y = local[1], z = local[2];
  const double ax = std::fabs(x), ay = std::fabs(y), az = std::fabs(z);
  int side;
  if (ax > ay && ax > az) side = x < 0.0 ? 0 : 3;
  else if (az > ay) side = z > 0.0 ? 1 : 4;
  else side = y > 0.0 ? 2 : 5;

  // raw face uv tables (coordinate.py FACE_UV_NUM/DEN)
  static constexpr double kNum[6][2][3] = {
      {{0, 0, -1}, {0, 1, 0}},  {{1, 0, 0}, {0, -1, 0}},
      {{1, 0, 0}, {0, 0, 1}},   {{0, -1, 0}, {0, 0, 1}},
      {{0, 1, 0}, {-1, 0, 0}},  {{0, 0, -1}, {-1, 0, 0}},
  };
  static constexpr double kDen[6][3] = {
      {1, 0, 0}, {0, 0, 1}, {0, 1, 0}, {1, 0, 0}, {0, 0, 1}, {0, 1, 0},
  };
  const double den = kDen[side][0] * x + kDen[side][1] * y + kDen[side][2] * z;
  double uvc[2];
  for (int k = 0; k < 2; ++k) {
    const double raw = (kNum[side][k][0] * x + kNum[side][k][1] * y +
                        kNum[side][k][2] * z) / den;
    // sigmoid forward warp (coordinate.rs:96-97)
    const double w = raw * std::sqrt((1.0 + kCSqr) / (1.0 + kCSqr * raw * raw));
    uvc[k] = 0.5 * w + 0.5;
  }

  // project onto every face: SideInfo codes F0=0 F1=1 PS=2 PT=3
  // (coordinate.py _EVEN_LIST/_ODD_LIST, coordinate.rs:19-52)
  static constexpr int kEven[6][2] = {{2, 3}, {0, 3}, {0, 2},
                                      {3, 2}, {3, 0}, {2, 0}};
  static constexpr int kOdd[6][2] = {{2, 3}, {2, 1}, {3, 1},
                                     {3, 2}, {1, 2}, {1, 3}};
  const double cand[4] = {0.0, 1.0, uvc[0], uvc[1]};
  for (int other = 0; other < 6; ++other) {
    const int idx = (6 + other - side) % 6;
    const int *info = (side % 2 == 0) ? kEven[idx] : kOdd[idx];
    uv6[2 * other + 0] = cand[info[0]];
    uv6[2 * other + 1] = cand[info[1]];
  }
}

void tr_taylor_from_world(const double *view, const double *m,
                          const double *lm, double origin_count,
                          int32_t *origin_xy, float *origin_uv,
                          float *coeffs) {
  double uv6[12];
  tr_project_view_uv(view, lm, uv6);
  tr_taylor_spherical(uv6, view, m, origin_count, origin_xy, origin_uv, coeffs);
}

// Per-(side, lod) tree origin + view tile coordinates for the wrapping
// tile tree (ops/tile_tree.py::compute_view_anchors, the twin of
// tile_tree.rs:175-191). uv6 = per-side view uv (S x 2, from
// tr_project_view_uv for spheres or host math otherwise). Outputs
// origins/view_tile_int (S*L*2 i32) and view_tile_frac (S*L*2 f32).
void tr_view_anchors(const double *uv6, int32_t S, int32_t L, int32_t T,
                     int32_t *origins, int32_t *view_int, float *view_frac) {
  for (int side = 0; side < S; ++side) {
    for (int lod = 0; lod < L; ++lod) {
      const double count = static_cast<double>(1u << lod);
      for (int k = 0; k < 2; ++k) {
        double txy = uv6[2 * side + k] * count;
        if (txy > count - 0.000001) txy = count - 0.000001;
        // numpy round = half-to-even; std::round is half-away -> nearbyint
        double org = std::nearbyint(txy - 0.5 * T);
        const double max_org = count - T > 0.0 ? count - T : 0.0;
        if (org < 0.0) org = 0.0;
        if (org > max_org) org = max_org;
        const int64_t o = (static_cast<int64_t>(side) * L + lod) * 2 + k;
        origins[o] = static_cast<int32_t>(org);
        const double fl = std::floor(txy);
        view_int[o] = static_cast<int32_t>(fl);
        double fr = std::fmod(txy, 1.0);
        if (fr < 0.0) fr += 1.0;
        view_frac[o] = static_cast<float>(fr);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Single-point CPU bilinear attachment tap
// (terrain_data/attachment.py::sample_bilinear_host, the twin of the
// reference's AttachmentData::sample, terrain_data/mod.rs:221-264).
// uv already border-inset (scale/offset applied by the caller). dtype:
// 0 = u8, 1 = u16, 2 = f32. Writes 4 doubles (padded like the Vec4).
// ---------------------------------------------------------------------------

void tr_sample_bilinear(const void *data, int32_t size, int32_t channels,
                        int32_t dtype, double max_value, double u, double v,
                        double *out4) {
  const double fx0 = u * size - 0.5, fy0 = v * size - 0.5;
  const double bx = std::floor(fx0), by = std::floor(fy0);
  const double fx = fx0 - bx, fy = fy0 - by;
  auto texel = [&](int64_t ix, int64_t iy, double *t4) {
    ix = ix < 0 ? 0 : (ix >= size ? size - 1 : ix);
    iy = iy < 0 ? 0 : (iy >= size ? size - 1 : iy);
    const int64_t o = (iy * size + ix) * channels;
    for (int c = 0; c < 4; ++c) {
      if (c >= channels) {
        t4[c] = 0.0;
        continue;
      }
      double raw;
      if (dtype == 0) raw = static_cast<const uint8_t *>(data)[o + c];
      else if (dtype == 1) raw = static_cast<const uint16_t *>(data)[o + c];
      else raw = static_cast<const float *>(data)[o + c];
      t4[c] = raw / max_value;
    }
  };
  double v00[4], v10[4], v01[4], v11[4];
  const int64_t ix = static_cast<int64_t>(bx), iy = static_cast<int64_t>(by);
  texel(ix, iy, v00);
  texel(ix + 1, iy, v10);
  texel(ix, iy + 1, v01);
  texel(ix + 1, iy + 1, v11);
  for (int c = 0; c < 4; ++c) {  // reference lerp order: y then x
    const double left = v00[c] + (v01[c] - v00[c]) * fy;
    const double right = v10[c] + (v11[c] - v10[c]) * fy;
    out4[c] = left + (right - left) * fx;
  }
}

// ---------------------------------------------------------------------------
// Preprocess hot loops (host path). Byte-identical twins of the numpy
// formulas in ops/preprocess.py (the oracle the device path is parity-
// tested against): quantization uses f32 multiply + round-half-to-even
// exactly like `np.rint(region_f32 * max_value)` (numpy 2 weak promotion
// keeps f32); downsample accumulates the nodata-masked 2x2 child average
// in f64 like downsample_tile.

// dtype codes match native/__init__._DTYPE_CODES: 0 = u8, 1 = u16.
void tr_quantize(const float *src, int64_t n, double max_value,
                 int32_t dtype_code, void *out) {
  const float mv = static_cast<float>(max_value);
  if (dtype_code == 0) {
    uint8_t *o = static_cast<uint8_t *>(out);
    for (int64_t i = 0; i < n; ++i) {
      float v = nearbyintf(src[i] * mv);
      if (v < 0.0f) v = 0.0f;
      if (v > mv) v = mv;
      o[i] = static_cast<uint8_t>(v);
    }
  } else {
    uint16_t *o = static_cast<uint16_t *>(out);
    for (int64_t i = 0; i < n; ++i) {
      float v = nearbyintf(src[i] * mv);
      if (v < 0.0f) v = 0.0f;
      if (v > mv) v = mv;
      o[i] = static_cast<uint16_t>(v);
    }
  }
}

}  // extern "C" — templates cannot carry C linkage

// Parent tile from its 4 children (ops/preprocess.py::downsample_tile,
// downsample.wgsl:12-45): parent center texel = nodata-masked f64 average
// of the 2x2 child-center quad, rounded half-to-even; borders zero.
// children ordered (2x,2y), (2x+1,2y), (2x,2y+1), (2x+1,2y+1); null ==
// missing (counts as nodata). dtype code 0 = u8, 1 = u16.
template <typename T>
static void downsample_impl(const void *const children[4], int64_t ts,
                            int64_t b, int64_t C, T *out) {
  const int64_t center = ts - 2 * b;
  const int64_t half = center / 2;  // center is even in every real config,
  // so a parent texel's 2x2 child quad never straddles two children:
  // quadrant (qy, qx) of the parent center reads only child 2*qy + qx.
  double acc[4];
  for (int qy = 0; qy < 2; ++qy) {
    for (int qx = 0; qx < 2; ++qx) {
      const T *data = static_cast<const T *>(children[2 * qy + qx]);
      if (data == nullptr) continue;  // nodata: borders stay memset zero
      for (int64_t i2 = 0; i2 < half; ++i2) {
        const int64_t i = qy * half + i2;  // parent center row
        const T *r0 = data + ((b + 2 * i2) * ts + b) * C;
        const T *r1 = r0 + ts * C;
        T *o = out + ((b + i) * ts + (b + qx * half)) * C;
        if (C == 1) {
          // single channel: nodata == the value itself is zero, so the
          // masked sum is just the plain sum (zeros add nothing) and the
          // count is branchless. Pure integer arithmetic: a u16 quad sum
          // is exact in f64, so np.rint(sum/count) (half-to-even) has an
          // exact integer form for counts 4/2/1 — only the count==3 case
          // needs the double divide (parity-fuzzed in test_torch_native.py).
          for (int64_t j2 = 0; j2 < half; ++j2) {
            const uint32_t v00 = r0[2 * j2], v01 = r0[2 * j2 + 1];
            const uint32_t v10 = r1[2 * j2], v11 = r1[2 * j2 + 1];
            const uint32_t sum = v00 + v01 + v10 + v11;
            const int count = (v00 != 0) + (v01 != 0) + (v10 != 0) +
                              (v11 != 0);
            uint32_t res;
            if (count == 4 || sum == 0) {
              const uint32_t q = sum >> 2, r = sum & 3;
              res = q + (r == 3) + ((r == 2) & (q & 1));
            } else if (count == 2) {
              const uint32_t q = sum >> 1;
              res = q + (sum & 1 & q);
            } else if (count == 1) {
              res = sum;
            } else {  // count == 3: 1/3 is inexact — defer to the f64 oracle
              res = static_cast<uint32_t>(
                  nearbyint(static_cast<double>(sum) / 3.0));
            }
            o[j2] = static_cast<T>(res);
          }
          continue;
        }
        for (int64_t j2 = 0; j2 < half; ++j2) {
          const T *t00 = r0 + 2 * j2 * C;
          const T *t01 = t00 + C;
          const T *t10 = r1 + 2 * j2 * C;
          const T *t11 = t10 + C;
          int count = 0;
          for (int64_t c = 0; c < C; ++c) acc[c] = 0.0;
          // tap order (dy, dx) = (0,0), (0,1), (1,0), (1,1) matches the
          // numpy quads reshape
          const T *taps[4] = {t00, t01, t10, t11};
          for (int t = 0; t < 4; ++t) {
            bool nz = false;
            for (int64_t c = 0; c < C; ++c)
              if (taps[t][c] != 0) { nz = true; break; }
            if (!nz) continue;
            ++count;
            for (int64_t c = 0; c < C; ++c)
              acc[c] += static_cast<double>(taps[t][c]);
          }
          for (int64_t c = 0; c < C; ++c) {
            const double avg = count > 0 ? acc[c] / count : 0.0;
            o[j2 * C + c] = static_cast<T>(nearbyint(avg));
          }
        }
      }
    }
  }
}

extern "C" void tr_downsample(const void *c0, const void *c1, const void *c2,
                   const void *c3, int32_t dtype_code, int64_t texture_size,
                   int64_t border, int64_t channels, void *out) {
  const void *children[4] = {c0, c1, c2, c3};
  const int64_t ts = texture_size, b = border, C = channels;
  const int64_t out_bytes = ts * ts * C * (dtype_code == 0 ? 1 : 2);
  std::memset(out, 0, static_cast<size_t>(out_bytes));
  if (dtype_code == 0) {
    downsample_impl<uint8_t>(children, ts, b, C, static_cast<uint8_t *>(out));
  } else {
    downsample_impl<uint16_t>(children, ts, b, C,
                              static_cast<uint16_t *>(out));
  }
}
