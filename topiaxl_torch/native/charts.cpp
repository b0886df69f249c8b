// Chart segmentation by normal-cone region growing (xatlas-style chart
// growth — the host stage of the "Better" LSCM unwrap path; see
// topiaxl_torch/extract/lscm.py:segment_charts for the numpy/Python spec and
// the reference slot it fills, inference.py:152-160).
//
// Same traversal as the Python implementation: BFS from each unlabeled
// seed (FIFO growth yields compact, roundish charts — DFS grew snakes
// whose wiggly outlines packed at ~40% atlas coverage), admitting an
// edge-adjacent face when its normal lies within the cone
// (dot >= cos_t) of the RUNNING chart normal, which is the normalized
// running sum of admitted face normals; charts are capped at
// max_faces. Doubles for the running normal, matching Python floats.

#include <cstdint>
#include <cmath>
#include <deque>
#include <vector>

extern "C" int chart_segment(
    const float* fn,          // [F, 3] unit face normals
    const int64_t* indptr,    // [F + 1] CSR adjacency
    const int64_t* indices,   // [nnz]
    int64_t F,
    float cos_t,
    int64_t max_faces,
    int64_t* labels_out)      // [F]
{
    if (F <= 0) return 0;
    for (int64_t i = 0; i < F; ++i) labels_out[i] = -1;
    std::deque<int64_t> queue;

    int64_t chart = 0;
    for (int64_t seed = 0; seed < F; ++seed) {
        if (labels_out[seed] >= 0) continue;
        labels_out[seed] = chart;
        double nx = fn[seed * 3 + 0];
        double ny = fn[seed * 3 + 1];
        double nz = fn[seed * 3 + 2];
        int64_t count = 1;
        queue.clear();
        queue.push_back(seed);
        while (!queue.empty() && count < max_faces) {
            int64_t cur = queue.front();
            queue.pop_front();
            for (int64_t k = indptr[cur]; k < indptr[cur + 1]; ++k) {
                int64_t nb = indices[k];
                if (labels_out[nb] >= 0) continue;
                double bx = fn[nb * 3 + 0];
                double by = fn[nb * 3 + 1];
                double bz = fn[nb * 3 + 2];
                if (bx * nx + by * ny + bz * nz < (double)cos_t) continue;
                labels_out[nb] = chart;
                double sx = nx * (double)count + bx;
                double sy = ny * (double)count + by;
                double sz = nz * (double)count + bz;
                ++count;
                double nrm = std::sqrt(sx * sx + sy * sy + sz * sz);
                double inv = 1.0 / (nrm > 1e-12 ? nrm : 1e-12);
                nx = sx * inv; ny = sy * inv; nz = sz * inv;
                queue.push_back(nb);
            }
        }
        ++chart;
    }
    return 0;
}
