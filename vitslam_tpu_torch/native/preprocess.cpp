// Native host-side preprocessing kernels for the data loader (the port's
// copy of vitslam_tpu/native/preprocess.cpp, built by g++ at first use into
// vitslam_tpu_torch/_build/ and bound with ctypes by native/bindings.py):
//   * lidar_splat_depth: project LiDAR points, bilinear 4-neighbor splat
//     with z-buffer + epsilon-window weighted averaging (order-independent
//     formulation: all contributions within eps of each pixel's minimum are
//     averaged);
//   * depth_to_points: back-project a depth map into camera + world points
//     with a validity mask.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// points: (N, 3) xyz; K: (9,) row-major 3x3; extr: (12,) row-major 3x4 w2c
// depth_out: (H*W,) zeroed by caller
void lidar_splat_depth(
    const float* points, int64_t n_points,
    const double* K, const double* extr,
    int64_t H, int64_t W, float eps,
    float* depth_out)
{
    const int64_t hw = H * W;
    float* zbuf = new float[hw];
    float* wsum = new float[hw];
    float* wzsum = new float[hw];
    for (int64_t i = 0; i < hw; ++i) {
        zbuf[i] = std::numeric_limits<float>::infinity();
        wsum[i] = 0.f;
        wzsum[i] = 0.f;
    }

    // precompute P = K @ extr (3x4)
    double P[12];
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 4; ++c) {
            double acc = 0.0;
            for (int k = 0; k < 3; ++k) acc += K[r * 3 + k] * extr[k * 4 + c];
            P[r * 4 + c] = acc;
        }

    // pass 1: z-buffer (scatter min over the 4 bilinear neighbors)
    // pass 2: epsilon-window weighted average. Two passes keep the result
    // order-independent (well-defined limit of the reference's running
    // average).
    const int64_t max_pts = n_points;
    float* px = new float[max_pts];
    float* py = new float[max_pts];
    float* pz = new float[max_pts];
    int64_t m = 0;
    for (int64_t i = 0; i < n_points; ++i) {
        const float x = points[i * 3 + 0];
        const float y = points[i * 3 + 1];
        const float z = points[i * 3 + 2];
        const double cx = P[0] * x + P[1] * y + P[2] * z + P[3];
        const double cy = P[4] * x + P[5] * y + P[6] * z + P[7];
        const double cz = P[8] * x + P[9] * y + P[10] * z + P[11];
        if (cz <= 0.0) continue;
        const double u = cx / cz;
        const double v = cy / cz;
        if (u < 0.0 || u >= (double)W || v < 0.0 || v >= (double)H) continue;
        px[m] = (float)u;
        py[m] = (float)v;
        pz[m] = (float)cz;
        ++m;
    }

    auto splat = [&](int pass) {
        for (int64_t i = 0; i < m; ++i) {
            const float u = px[i], v = py[i], z = pz[i];
            const int64_t j0 = (int64_t)std::floor(u);
            const int64_t i0 = (int64_t)std::floor(v);
            const float du = u - (float)j0;
            const float dv = v - (float)i0;
            const float w4[4] = {(1 - du) * (1 - dv), du * (1 - dv),
                                 (1 - du) * dv, du * dv};
            const int64_t ri[4] = {i0, i0, i0 + 1, i0 + 1};
            const int64_t ci[4] = {j0, j0 + 1, j0, j0 + 1};
            for (int k = 0; k < 4; ++k) {
                if (w4[k] <= 0.f) continue;
                const int64_t r = ri[k], c = ci[k];
                if (r < 0 || r >= H || c < 0 || c >= W) continue;
                const int64_t idx = r * W + c;
                if (pass == 0) {
                    if (z < zbuf[idx]) zbuf[idx] = z;
                } else if (z <= zbuf[idx] + eps) {
                    wsum[idx] += w4[k];
                    wzsum[idx] += w4[k] * z;
                }
            }
        }
    };
    splat(0);
    splat(1);

    for (int64_t i = 0; i < hw; ++i)
        depth_out[i] = wsum[i] > 0.f ? wzsum[i] / wsum[i] : 0.f;

    delete[] zbuf;
    delete[] wsum;
    delete[] wzsum;
    delete[] px;
    delete[] py;
    delete[] pz;
}

// depth: (H*W,); K: (9,) 3x3; extr: (12,) 3x4 w2c
// world/cam: (H*W*3,), mask: (H*W,) uint8
void depth_to_points(
    const float* depth, int64_t H, int64_t W,
    const double* K, const double* extr,
    float* world, float* cam, uint8_t* mask)
{
    // K^-1 (K upper-triangular pinhole assumed general 3x3: invert)
    double k[9];
    std::memcpy(k, K, sizeof(k));
    const double det =
        k[0] * (k[4] * k[8] - k[5] * k[7]) -
        k[1] * (k[3] * k[8] - k[5] * k[6]) +
        k[2] * (k[3] * k[7] - k[4] * k[6]);
    const double id = 1.0 / det;
    double ki[9] = {
        (k[4] * k[8] - k[5] * k[7]) * id,
        (k[2] * k[7] - k[1] * k[8]) * id,
        (k[1] * k[5] - k[2] * k[4]) * id,
        (k[5] * k[6] - k[3] * k[8]) * id,
        (k[0] * k[8] - k[2] * k[6]) * id,
        (k[2] * k[3] - k[0] * k[5]) * id,
        (k[3] * k[7] - k[4] * k[6]) * id,
        (k[1] * k[6] - k[0] * k[7]) * id,
        (k[0] * k[4] - k[1] * k[3]) * id,
    };
    const double* R = extr;  // rows of 3x4
    for (int64_t r = 0; r < H; ++r) {
        for (int64_t c = 0; c < W; ++c) {
            const int64_t idx = r * W + c;
            const double d = depth[idx];
            const double rx = ki[0] * c + ki[1] * r + ki[2];
            const double ry = ki[3] * c + ki[4] * r + ki[5];
            const double rz = ki[6] * c + ki[7] * r + ki[8];
            const double cxp = rx * d, cyp = ry * d, czp = rz * d;
            cam[idx * 3 + 0] = (float)cxp;
            cam[idx * 3 + 1] = (float)cyp;
            cam[idx * 3 + 2] = (float)czp;
            // world = R^T (cam - t)
            const double vx = cxp - R[3], vy = cyp - R[7], vz = czp - R[11];
            world[idx * 3 + 0] = (float)(R[0] * vx + R[4] * vy + R[8] * vz);
            world[idx * 3 + 1] = (float)(R[1] * vx + R[5] * vy + R[9] * vz);
            world[idx * 3 + 2] = (float)(R[2] * vx + R[6] * vy + R[10] * vz);
            mask[idx] = (d > 0.0 && std::isfinite(d)) ? 1 : 0;
        }
    }
}

}  // extern "C"
