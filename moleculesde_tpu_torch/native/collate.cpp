// Native batch collation: fill fixed-shape padded graph arrays.
//
// The host-side hot loop of the padded ingest (the reference's PyG collate
// in its DataLoader workers): given B molecules' concatenated feature and
// edge arrays and per-graph offsets, scatter them into the node-major
// padded layout of moleculesde_tpu_torch.core.batch.GraphBatch.  The port's
// copy of the JAX package's native/collate.cpp, the same C ABI, consumed
// through ctypes by moleculesde_tpu_torch/data/native_collate.py, which
// builds it with g++ on first use.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Returns 0 on success. All output arrays must be pre-zeroed by the caller.
int collate_graphs(
    // inputs (concatenated across graphs, with [B+1] offset arrays)
    const int32_t* atom_feats,      // [total_atoms, n_feat]
    const float*   positions,       // [total_atoms, 3] or nullptr
    const int64_t* atom_offsets,    // [B+1]
    const int32_t* edge_index,      // [2, total_edges] (row-major: src then dst)
    const int32_t* edge_feats,      // [total_edges, n_efeat] or nullptr
    const int64_t* edge_offsets,    // [B+1]
    const int32_t* ext_index,       // [2, total_ext] or nullptr
    const int32_t* ext_attr,        // [total_ext] or nullptr
    const int64_t* ext_offsets,     // [B+1] or nullptr
    int64_t batch, int64_t n_max, int64_t e_max, int64_t ext_e_max,
    int64_t n_feat, int64_t n_efeat,
    int64_t total_edges, int64_t total_ext,
    // outputs (padded, node-major)
    int32_t* out_atom_feats,        // [B*n_max, n_feat]
    uint8_t* out_node_mask,         // [B*n_max]
    float*   out_positions,         // [B*n_max, 3]
    int32_t* out_edge_src,          // [B*e_max]
    int32_t* out_edge_dst,          // [B*e_max]
    int32_t* out_edge_feats,        // [B*e_max, n_efeat]
    uint8_t* out_edge_mask,         // [B*e_max]
    int32_t* out_ext_src,           // [B*ext_e_max]
    int32_t* out_ext_dst,           // [B*ext_e_max]
    int32_t* out_ext_attr,          // [B*ext_e_max]
    uint8_t* out_ext_mask)          // [B*ext_e_max]
{
    const int32_t* edge_src_in = edge_index;                    // [total_edges]
    const int32_t* edge_dst_in = edge_index + total_edges;
    const int32_t* ext_src_in = ext_index ? ext_index : nullptr;
    const int32_t* ext_dst_in = ext_index ? ext_index + total_ext : nullptr;

    for (int64_t g = 0; g < batch; ++g) {
        const int64_t a0 = atom_offsets[g];
        const int64_t n_raw = atom_offsets[g + 1] - a0;
        const int64_t n = std::min(n_raw, n_max);
        const int64_t base = g * n_max;

        std::memcpy(out_atom_feats + base * n_feat, atom_feats + a0 * n_feat,
                    sizeof(int32_t) * n * n_feat);
        std::memset(out_node_mask + base, 1, n);
        if (positions) {
            std::memcpy(out_positions + base * 3, positions + a0 * 3,
                        sizeof(float) * n * 3);
        }

        // bond edges
        {
            const int64_t e0 = edge_offsets[g];
            const int64_t e_raw = edge_offsets[g + 1] - e0;
            const int64_t ebase = g * e_max;
            int64_t k = 0;
            for (int64_t e = 0; e < e_raw && k < e_max; ++e) {
                const int32_t s = edge_src_in[e0 + e];
                const int32_t d = edge_dst_in[e0 + e];
                if (s >= n || d >= n) continue;  // truncated-node edges
                out_edge_src[ebase + k] = static_cast<int32_t>(base) + s;
                out_edge_dst[ebase + k] = static_cast<int32_t>(base) + d;
                out_edge_mask[ebase + k] = 1;
                if (edge_feats) {
                    std::memcpy(out_edge_feats + (ebase + k) * n_efeat,
                                edge_feats + (e0 + e) * n_efeat,
                                sizeof(int32_t) * n_efeat);
                }
                ++k;
            }
        }

        // extended edges
        if (ext_index && ext_offsets) {
            const int64_t x0 = ext_offsets[g];
            const int64_t x_raw = ext_offsets[g + 1] - x0;
            const int64_t xbase = g * ext_e_max;
            int64_t k = 0;
            for (int64_t e = 0; e < x_raw && k < ext_e_max; ++e) {
                const int32_t s = ext_src_in[x0 + e];
                const int32_t d = ext_dst_in[x0 + e];
                if (s >= n || d >= n) continue;
                out_ext_src[xbase + k] = static_cast<int32_t>(base) + s;
                out_ext_dst[xbase + k] = static_cast<int32_t>(base) + d;
                out_ext_mask[xbase + k] = 1;
                if (ext_attr) out_ext_attr[xbase + k] = ext_attr[x0 + e];
                ++k;
            }
        }
    }
    return 0;
}

}  // extern "C"
