// Native point-cloud CSV parser.
//
// C++ replacement for the reference's fscanf loader (readCloudFromFile,
// main.cpp:145-179) with the same row-selection semantics:
// parse "x,y,z" rows; when subsample_freq > 0 keep the first
// `subsample_after` rows and every `subsample_freq`-th row after that
// (by row counter). ~30x faster than the Python loader on the 18,475-row
// biceps file; matters for the 100k+ multi-muscle scenes and repeated
// scene loads in sweeps.
//
// Exposed with a plain C ABI for ctypes. The PyTorch port keeps its own copy
// of the JAX package's source (same ABI); runtime/__init__.py builds it.

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse up to `capacity` points from `path` into `out` (xyz interleaved).
// Returns the number of points written, or -1 if the file can't be opened.
// `total_rows_out` (optional) receives the number of parsed data rows
// before subsampling.
long long sphsm_parse_cloud_csv(const char* path, float* out,
                                long long capacity, int subsample_freq,
                                int subsample_after,
                                long long* total_rows_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;

    // read the whole file (these assets are <1 MB; bulk read beats getline)
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return -1; }
    size_t rd = std::fread(buf, 1, size, f);
    std::fclose(f);
    buf[rd] = '\0';

    long long count = 0;      // points kept
    long long counter = 0;    // rows seen (reference's `counter`)
    char* p = buf;
    while (*p) {
        // parse one line: x,y,z
        char* q = p;
        float x = std::strtof(p, &q);
        bool ok = q != p && *q == ',';
        float y = 0.f, z = 0.f;
        if (ok) {
            p = q + 1;
            y = std::strtof(p, &q);
            ok = q != p && *q == ',';
        }
        if (ok) {
            p = q + 1;
            z = std::strtof(p, &q);
            ok = q != p;
        }
        // advance to next line
        char* nl = std::strchr(q, '\n');
        p = nl ? nl + 1 : q + std::strlen(q);

        if (ok) {
            bool keep = true;
            if (subsample_freq > 0) {
                keep = (counter < subsample_after)
                       || (counter % subsample_freq == 0);
            }
            if (keep && count < capacity) {
                out[count * 3 + 0] = x;
                out[count * 3 + 1] = y;
                out[count * 3 + 2] = z;
                ++count;
            }
        }
        ++counter;
    }
    if (total_rows_out) *total_rows_out = counter;
    std::free(buf);
    return count;
}

}  // extern "C"
