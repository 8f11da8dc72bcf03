// Clean-room C++ implementation of the correlative scan-to-map SLAM pipeline.
//
// Role: the in-repo correctness & speed oracle for the JAX framework — the
// same role Subsystem_1/main.c plays for the reference project (see SURVEY.md
// §2.2 N1). This is NOT a copy of the reference: it is written fresh from the
// behavioral spec in SURVEY.md §3 with our own structure; it intentionally
// reproduces the reference's observable behaviors (transposed-rotation
// transform, roundf cell snapping, strict-< argmin in theta/tx/ty loop order,
// clamped EDT, the bestHits buffer aliasing in map updates) so that
// C-vs-JAX trajectory comparisons are meaningful.
//
// Exposed via extern "C" for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

namespace tpuslam {

// Deterministic f32 sin/cos — the bit-exact twin of
// lidar_slam_tpu/core/trig32.py (see its docstring). Cody-Waite pi/2
// reduction + cephes minimax polynomials in a fixed op order; compiled with
// -ffp-contract=off so every multiply/add rounds exactly like XLA:CPU's.
// Any edit here must be mirrored in trig32.py.
inline void sincos32(float x, float* s_out, float* c_out) {
  const float kTwoOverPi = 0.63661975f;           // 0x3f22f983
  const float kH1 = 1.5703125f;                   // 0x3fc90000
  const float kH2 = 4.837512969970703e-4f;        // 0x39fda000
  const float kH3 = 7.549789415861596e-8f;        // 0x33a22169
  const float kS1 = -1.6666654611e-1f, kS2 = 8.3321608736e-3f,
              kS3 = -1.9515295891e-4f;
  const float kC1 = 4.166664568298827e-2f, kC2 = -1.388731625493765e-3f,
              kC3 = 2.443315711809948e-5f;
  float t = x * kTwoOverPi;
  float half = (t > 0.0f) ? 0.5f : ((t < 0.0f) ? -0.5f : 0.0f);
  float k = std::trunc(t + half);
  float r = ((x - k * kH1) - k * kH2) - k * kH3;
  float r2 = r * r;
  float sp = (kS3 * r2 + kS2) * r2 + kS1;
  float sinr = (sp * r2) * r + r;
  float cp = (kC3 * r2 + kC2) * r2 + kC1;
  float cosr = (cp * r2) * r2 + (1.0f - 0.5f * r2);
  int q = (int)k % 4;
  if (q < 0) q += 4;
  switch (q) {
    case 0: *s_out = sinr;  *c_out = cosr;  break;
    case 1: *s_out = cosr;  *c_out = -sinr; break;
    case 2: *s_out = -sinr; *c_out = -cosr; break;
    default: *s_out = -cosr; *c_out = sinr; break;
  }
}

// 2^-10 lattice snap for EDT outputs — the twin of ops/edt.quantize_metric
// (see its comment: it makes f32 matcher-score sums order-independent, the
// second leg of full-scale trajectory parity alongside sincos32).
// roundf on the half-ulp lattice exactly as the JAX side computes it
// (core/gridmap.roundf_like = trunc(x + sign(x)*0.5)): the two differ from
// libm roundf only when x + 0.5 rounds up across an integer in f32 — rare,
// but one flip forks the trajectory (observed at scan 2696 of building-3800).
inline float roundf_like(float x) {
  float half = (x > 0.0f) ? 0.5f : ((x < 0.0f) ? -0.5f : 0.0f);
  return std::trunc(x + half);
}

inline float quantize_metric(float d) {
  return std::trunc(d * 1024.0f + 0.5f) * (1.0f / 1024.0f);
}

struct Config {
  int n_beams = 1079;
  float angle_min = -2.351831f;
  float angle_inc = 0.004363f;
  float range_min = 0.023f;
  float usable_range = 24.0f;
  float coarse_pixel = 0.2f;
  float fine_pixel = 0.1f;
  int coarse_size = 200;
  int fine_size = 400;
  float border = 1.0f;
  int margin_px = 3;
  float max_dist_px = 10.0f;
  float coarse_t = 0.05f, coarse_r = 0.008727f;
  float fine_t = 0.025f, fine_r = 0.004363f;
  float mini_dt = 0.3f, mini_dr = 0.0872665f;
  float new_point_thresh = 1.5f;
  int map_capacity = 20000;
  int use_naive_edt = 0;  // 1: O(N^4) brute force (baseline timing parity)
};

struct Grid {
  std::vector<float> metric;  // size*size, row-major
  int n_rows = 0, n_cols = 0;
  float origin_x = 0.f, origin_y = 0.f;
  float pixel = 0.f;
  int stride = 0;
};

class Pipeline {
 public:
  explicit Pipeline(const Config& cfg) : cfg_(cfg) {
    angles_.resize(cfg.n_beams);
    float a = cfg.angle_min;
    for (int i = 0; i < cfg.n_beams; ++i) {
      angles_[i] = a;
      a += cfg.angle_inc;
    }
    map_x_.reserve(cfg.map_capacity);
    map_y_.reserve(cfg.map_capacity);
    coarse_.metric.assign((size_t)cfg.coarse_size * cfg.coarse_size, 0.f);
    coarse_.stride = cfg.coarse_size;
    coarse_.pixel = cfg.coarse_pixel;
    fine_.metric.assign((size_t)cfg.fine_size * cfg.fine_size, 0.f);
    fine_.stride = cfg.fine_size;
    fine_.pixel = cfg.fine_pixel;
    occ_c_.assign(coarse_.metric.size(), 0);
    occ_f_.assign(fine_.metric.size(), 0);
  }

  // Gate + polar->cartesian (compacting), ref readAScan semantics.
  void ReadScan(const float* ranges) {
    sx_.clear();
    sy_.clear();
    for (int i = 0; i < cfg_.n_beams; ++i) {
      float r = ranges[i];
      if (r < cfg_.range_min || r > cfg_.usable_range) continue;
      float s, c;
      sincos32(angles_[i], &s, &c);
      sx_.push_back(r * c);
      sy_.push_back(r * s);
    }
  }

  // Reference-convention rigid transform: w = A(theta) p + t,
  // A = [[c, s], [-s, c]].
  void TransformScan(const float* pose) {
    float s, c;
    sincos32(pose[2], &s, &c);
    size_t n = sx_.size();
    wx_.resize(n);
    wy_.resize(n);
    for (size_t i = 0; i < n; ++i) {
      wx_[i] = c * sx_[i] + s * sy_[i] + pose[0];
      wy_[i] = -s * sx_[i] + c * sy_[i] + pose[1];
    }
  }

  void InitMap(const float* pose) {
    map_x_.assign(wx_.begin(), wx_.end());
    map_y_.assign(wy_.begin(), wy_.end());
    std::memcpy(key_pose_, pose, sizeof key_pose_);
  }

  void BuildLocalMap() {
    float min_x = wx_[0], max_x = wx_[0], min_y = wy_[0], max_y = wy_[0];
    for (size_t i = 1; i < wx_.size(); ++i) {
      min_x = std::min(min_x, wx_[i]);
      max_x = std::max(max_x, wx_[i]);
      min_y = std::min(min_y, wy_[i]);
      max_y = std::max(max_y, wy_[i]);
    }
    min_x -= cfg_.border;
    min_y -= cfg_.border;
    max_x += cfg_.border;
    max_y += cfg_.border;
    lx_.clear();
    ly_.clear();
    for (size_t i = 0; i < map_x_.size(); ++i) {
      float x = map_x_[i], y = map_y_[i];
      if (x > min_x && x < max_x && y > min_y && y < max_y) {
        lx_.push_back(x);
        ly_.push_back(y);
      }
    }
  }

  void Rasterize(Grid& g, std::vector<uint8_t>& occ, float pixel, int size) {
    float min_x = lx_[0], max_x = lx_[0], min_y = ly_[0], max_y = ly_[0];
    for (size_t i = 1; i < lx_.size(); ++i) {
      min_x = std::min(min_x, lx_[i]);
      max_x = std::max(max_x, lx_[i]);
      min_y = std::min(min_y, ly_[i]);
      max_y = std::max(max_y, ly_[i]);
    }
    min_x -= cfg_.margin_px * pixel;
    min_y -= cfg_.margin_px * pixel;
    max_x += cfg_.margin_px * pixel;
    max_y += cfg_.margin_px * pixel;
    // Multiply by the f32 reciprocal (not divide): XLA:CPU's f32 division is
    // off by 1 ulp from IEEE at rare quotients; the JAX raster therefore
    // multiplies by 1/pixel, and the oracle must round identically.
    const float ipix = 1.0f / pixel;
    int cells_x = (int)roundf_like((max_x - min_x) * ipix) + 1;
    int cells_y = (int)roundf_like((max_y - min_y) * ipix) + 1;
    g.n_cols = cells_x;
    g.n_rows = cells_y;
    g.origin_x = min_x;
    g.origin_y = min_y;
    std::fill(occ.begin(), occ.end(), 0);
    for (size_t i = 0; i < lx_.size(); ++i) {
      int col = (int)roundf_like((lx_[i] - min_x) * ipix);
      int row = (int)roundf_like((ly_[i] - min_y) * ipix);
      if (row >= 0 && row < size && col >= 0 && col < size)
        occ[(size_t)row * size + col] = 1;
    }
  }

  // Clamped EDT, separable two-pass (exact under the clamp).
  void EdtSeparable(const std::vector<uint8_t>& occ, Grid& g, int size) {
    const int R = (int)cfg_.max_dist_px;
    const float kInf = std::numeric_limits<float>::infinity();
    int h = g.n_rows, w = g.n_cols;
    d1_.assign((size_t)h * w, kInf);
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = &occ[(size_t)y * size];
      float* d1r = &d1_[(size_t)y * w];
      for (int x = 0; x < w; ++x) {
        if (row[x]) {
          d1r[x] = 0.f;
          continue;
        }
        float best = kInf;
        int lo = std::max(0, x - R), hi = std::min(w - 1, x + R);
        for (int i = lo; i <= hi; ++i)
          if (row[i]) {
            float d = (float)((i - x) * (i - x));
            if (d < best) best = d;
          }
        d1r[x] = best;
      }
    }
    for (int y = 0; y < h; ++y) {
      float* out = &g.metric[(size_t)y * g.stride];
      for (int x = 0; x < w; ++x) {
        float best = d1_[(size_t)y * w + x];
        int lo = std::max(0, y - R), hi = std::min(h - 1, y + R);
        for (int j = lo; j <= hi; ++j) {
          float cand = d1_[(size_t)j * w + x] + (float)((j - y) * (j - y));
          if (cand < best) best = cand;
        }
        float dist =
            std::min(std::sqrt(best), cfg_.max_dist_px);
        out[x] = occ[(size_t)y * size + x] ? 0.f : quantize_metric(dist);
      }
    }
  }

  // Brute-force clamped EDT with the reference's exact update rule
  // (min_dist lowered only when d2 < min_dist^2) — for timing parity runs.
  void EdtNaive(const std::vector<uint8_t>& occ, Grid& g, int size) {
    int h = g.n_rows, w = g.n_cols;
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        float& out = g.metric[(size_t)y * g.stride + x];
        if (occ[(size_t)y * size + x]) {
          out = 0.f;
          continue;
        }
        float min_dist = cfg_.max_dist_px;
        for (int j = 0; j < h; ++j)
          for (int i = 0; i < w; ++i)
            if (occ[(size_t)j * size + i]) {
              int d2 = (i - x) * (i - x) + (j - y) * (j - y);
              if ((float)d2 < min_dist * min_dist)
                min_dist = std::sqrt((float)d2);
            }
        out = quantize_metric(min_dist);
      }
    }
  }

  void UpdateGrids() {
    BuildLocalMap();
    Rasterize(coarse_, occ_c_, cfg_.coarse_pixel, cfg_.coarse_size);
    Rasterize(fine_, occ_f_, cfg_.fine_pixel, cfg_.fine_size);
    if (cfg_.use_naive_edt) {
      EdtNaive(occ_c_, coarse_, cfg_.coarse_size);
      EdtNaive(occ_f_, fine_, cfg_.fine_size);
    } else {
      EdtSeparable(occ_c_, coarse_, cfg_.coarse_size);
      EdtSeparable(occ_f_, fine_, cfg_.fine_size);
    }
  }

  // One correlative match: argmin over the fixed 27-candidate set, in
  // theta-major / tx / ty order with strict-< updates. Fills last_hits_ with
  // the final candidate's compacted in-bounds values and best_count_ with the
  // best candidate's in-bounds count (the reference's bestHits semantics).
  void Match(const Grid& g, float* pose, float step_t, float step_r) {
    float ipix = 1.0f / g.pixel;
    size_t n = sx_.size();
    px_.resize(n);
    py_.resize(n);
    for (size_t i = 0; i < n; ++i) {
      px_[i] = sx_[i] * ipix;
      py_[i] = sy_[i] * ipix;
    }
    float thetas[3] = {pose[2] - step_r, pose[2], pose[2] + step_r};
    float txs[3] = {pose[0] - step_t, pose[0], pose[0] + step_t};
    float tys[3] = {pose[1] - step_t, pose[1], pose[1] + step_t};
    float best_score = std::numeric_limits<float>::infinity();
    float best_pose[3] = {pose[0], pose[1], pose[2]};
    for (int a = 0; a < 3; ++a) {
      float s, c;
      sincos32(thetas[a], &s, &c);
      rx_.resize(n);
      ry_.resize(n);
      for (size_t i = 0; i < n; ++i) {
        rx_[i] = px_[i] * c + py_[i] * s;
        ry_[i] = -px_[i] * s + py_[i] * c;
      }
      for (int b = 0; b < 3; ++b) {
        float offx = (txs[b] - g.origin_x) * ipix;
        for (int d = 0; d < 3; ++d) {
          float offy = (tys[d] - g.origin_y) * ipix;
          float score = 0.f;
          int cnt = 0;
          last_hits_.resize(n);
          for (size_t i = 0; i < n; ++i) {
            int cx = (int)roundf_like(rx_[i] + offx) + 1;
            int cy = (int)roundf_like(ry_[i] + offy) + 1;
            if (cx > 1 && cy > 1 && cx < g.n_cols && cy < g.n_rows) {
              float v = g.metric[(size_t)(cy - 1) * g.stride + (cx - 1)];
              last_hits_[cnt++] = v;
              score += v;
            }
          }
          last_count_ = cnt;
          if (score < best_score) {
            best_score = score;
            best_pose[0] = txs[b];
            best_pose[1] = tys[d];
            best_pose[2] = thetas[a];
            best_count_ = cnt;
            last_best_idx_ = (a * 3 + b) * 3 + d;
          }
        }
      }
    }
    pose[0] = best_pose[0];
    pose[1] = best_pose[1];
    pose[2] = best_pose[2];
    last_best_score_ = best_score;
  }

  // Run the whole dataset; writes poses (n_scans x 3) and returns map size.
  int Run(const float* ranges, int n_scans, float* out_path, float* out_map,
          int map_capacity_out) {
    float pose[3] = {0.f, 0.f, 0.f};
    ReadScan(ranges);
    TransformScan(pose);
    InitMap(pose);
    out_path[0] = out_path[1] = out_path[2] = 0.f;
    bool mini_updated = true;
    for (int t = 1; t < n_scans; ++t) {
      ReadScan(ranges + (size_t)t * cfg_.n_beams);
      bool transformed = false;
      if (mini_updated) {
        TransformScan(pose);
        transformed = true;
        UpdateGrids();
      }
      // Constant-velocity prior: guess = pose + (pose - path[t-2]); float ops
      // ordered as dp-then-add to match the JAX fidelity path bit-for-bit.
      float guess[3];
      if (t > 1) {
        const float* prev = out_path + (size_t)(t - 2) * 3;
        for (int i = 0; i < 3; ++i) guess[i] = pose[i] + (pose[i] - prev[i]);
      } else {
        for (int i = 0; i < 3; ++i) guess[i] = pose[i];
      }
      float matched[3] = {guess[0], guess[1], guess[2]};
      Match(mini_updated ? coarse_ : fine_, matched, cfg_.coarse_t,
            cfg_.coarse_r);
      if (dbg_) {
        float* row = dbg_ + (size_t)t * 8;
        row[0] = (float)last_best_idx_;
        row[1] = last_best_score_;
      }
      Match(fine_, matched, cfg_.fine_t, cfg_.fine_r);
      if (dbg_) {
        float* row = dbg_ + (size_t)t * 8;
        row[2] = (float)last_best_idx_;
        row[3] = last_best_score_;
        row[4] = (float)sx_.size();
        row[5] = (float)best_count_;
        row[6] = mini_updated ? 1.f : 0.f;
        row[7] = (float)map_x_.size();
      }
      float dp[3];
      for (int i = 0; i < 3; ++i) dp[i] = std::fabs(matched[i] - key_pose_[i]);
      if (dp[0] > cfg_.mini_dt || dp[1] > cfg_.mini_dt || dp[2] > cfg_.mini_dr) {
        mini_updated = true;
        if (!transformed) {
          std::memcpy(pose, matched, sizeof pose);
          TransformScan(pose);
        }
        int limit = std::min<int>(best_count_, (int)wx_.size());
        for (int j = 0; j < limit; ++j) {
          if (last_hits_[j] > cfg_.new_point_thresh &&
              (int)map_x_.size() < cfg_.map_capacity) {
            map_x_.push_back(wx_[j]);
            map_y_.push_back(wy_[j]);
          }
        }
        std::memcpy(key_pose_, matched, sizeof key_pose_);
      } else {
        mini_updated = false;
      }
      std::memcpy(pose, matched, sizeof pose);
      std::memcpy(out_path + (size_t)t * 3, pose, sizeof pose);
    }
    int msize = std::min<int>((int)map_x_.size(), map_capacity_out);
    if (out_map) {
      for (int i = 0; i < msize; ++i) {
        out_map[2 * i] = map_x_[i];
        out_map[2 * i + 1] = map_y_[i];
      }
    }
    return msize;
  }

 private:
  Config cfg_;
  std::vector<float> angles_;
  std::vector<float> sx_, sy_, wx_, wy_;      // current scan (sensor / world)
  std::vector<float> map_x_, map_y_;          // global point map
  std::vector<float> lx_, ly_;                // local map
  std::vector<uint8_t> occ_c_, occ_f_;
  std::vector<float> d1_;
  std::vector<float> px_, py_, rx_, ry_;      // matcher scratch
  std::vector<float> last_hits_;
  int last_count_ = 0, best_count_ = 0;
 public:
  int last_best_idx_ = -1;
  float last_best_score_ = 0.f;
  float* dbg_ = nullptr;   // instrumentation: 8 floats per scan when set
 private:
  Grid coarse_, fine_;
  float key_pose_[3] = {0.f, 0.f, 0.f};
};

}  // namespace tpuslam

extern "C" {

// Instrumented run: writes 8 floats per scan into dbg (m1 idx, m1 score,
// m2 idx, m2 score, gated beam count, best_count, miniUpdated-at-entry,
// map size). For parity debugging only.
int tpuslam_run_debug(const float* ranges, int n_scans, int n_beams,
                      float usable_range, int coarse_size, int fine_size,
                      int map_capacity, float* out_path, float* dbg) {
  tpuslam::Config cfg;
  cfg.n_beams = n_beams;
  if (usable_range > 0.f) cfg.usable_range = usable_range;
  if (coarse_size > 0) cfg.coarse_size = coarse_size;
  if (fine_size > 0) cfg.fine_size = fine_size;
  if (map_capacity > 0) cfg.map_capacity = map_capacity;
  tpuslam::Pipeline p(cfg);
  p.dbg_ = dbg;
  return p.Run(ranges, n_scans, out_path, nullptr, 0);
}


// Returns the number of map points written (<= map_capacity_out).
int tpuslam_run(const float* ranges, int n_scans, int n_beams, int use_naive_edt,
                float* out_path, float* out_map, int map_capacity_out) {
  tpuslam::Config cfg;
  cfg.n_beams = n_beams;
  cfg.use_naive_edt = use_naive_edt;
  tpuslam::Pipeline p(cfg);
  return p.Run(ranges, n_scans, out_path, out_map, map_capacity_out);
}

// Configurable variant for non-museum workloads (building-scale grids/maps).
// Zero/negative overrides keep the museum defaults.
int tpuslam_run_cfg(const float* ranges, int n_scans, int n_beams,
                    int use_naive_edt, float usable_range, int coarse_size,
                    int fine_size, int map_capacity, float* out_path,
                    float* out_map, int map_capacity_out) {
  tpuslam::Config cfg;
  cfg.n_beams = n_beams;
  cfg.use_naive_edt = use_naive_edt;
  if (usable_range > 0.f) cfg.usable_range = usable_range;
  if (coarse_size > 0) cfg.coarse_size = coarse_size;
  if (fine_size > 0) cfg.fine_size = fine_size;
  if (map_capacity > 0) cfg.map_capacity = map_capacity;
  tpuslam::Pipeline p(cfg);
  return p.Run(ranges, n_scans, out_path, out_map, map_capacity_out);
}

// Batch sincos probe (for trig32 bit-exactness tests).
void tpuslam_sincos32(const float* x, int n, float* s, float* c) {
  for (int i = 0; i < n; ++i) tpuslam::sincos32(x[i], &s[i], &c[i]);
}

// Standalone clamped EDT (for kernel unit tests): occ is h*w uint8,
// out is h*w float.
void tpuslam_edt(const uint8_t* occ, int h, int w, float max_dist, float* out) {
  const int R = (int)max_dist;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      if (occ[(size_t)y * w + x]) {
        out[(size_t)y * w + x] = 0.f;
        continue;
      }
      float min_dist = max_dist;
      int ylo = std::max(0, y - R), yhi = std::min(h - 1, y + R);
      int xlo = std::max(0, x - R), xhi = std::min(w - 1, x + R);
      for (int j = ylo; j <= yhi; ++j)
        for (int i = xlo; i <= xhi; ++i)
          if (occ[(size_t)j * w + i]) {
            int d2 = (i - x) * (i - x) + (j - y) * (j - y);
            if ((float)d2 < min_dist * min_dist)
              min_dist = std::sqrt((float)d2);
          }
      out[(size_t)y * w + x] = tpuslam::quantize_metric(min_dist);
    }
  }
}

// Fast CSV ingest: parse n_rows x n_cols comma-separated floats from a file.
// Returns rows parsed, or -1 on open failure.
int tpuslam_read_csv(const char* path, int n_rows, int n_cols, float* out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  static std::vector<char> buf;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize((size_t)size + 1);
  size_t got = std::fread(buf.data(), 1, (size_t)size, f);
  std::fclose(f);
  buf[got] = '\0';
  char* p = buf.data();
  int row = 0;
  while (row < n_rows && *p) {
    for (int c = 0; c < n_cols; ++c) {
      out[(size_t)row * n_cols + c] = std::strtof(p, &p);
      while (*p == ',' || *p == ' ') ++p;
    }
    while (*p == '\n' || *p == '\r') ++p;
    ++row;
  }
  return row;
}

}  // extern "C"
