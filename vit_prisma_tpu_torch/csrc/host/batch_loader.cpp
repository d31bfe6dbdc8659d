// Asynchronous prefetching batch loader for vit_prisma_tpu.
//
// The counterpart of the reference's torch DataLoader(num_workers=...)
// feeding VisionActivationsStore (activations_store.py:226-249): a worker
// thread pool reads + decodes + preprocesses image files AHEAD of the
// consumer into a bounded ring of ready host batch buffers, so the Python
// harvest loop only ever memcpys a finished batch.  Plain C ABI for
// ctypes (same convention as image_pipeline.cpp, which provides the
// per-image decode/preprocess kernels this file drives).
//
//   ip_loader_create  : paths + batch/out geometry + workers/depth -> handle
//   ip_loader_next    : block until a batch is ready, copy it out
//   ip_loader_destroy : stop workers, free buffers
//
// Sampling: epoch-wise Fisher-Yates permutations from a seeded mt19937_64
// (deterministic given seed; with n_workers > 1 the DELIVERY order of
// batches is unordered — the store reshuffles rows anyway).  Partial final
// batches are dropped, like the reference's drop_last=True store loader.
//
// Wire formats: float32 CHW (decode -> bicubic resize -> crop ->
// mean/std normalize) or uint8 CHW (resize + crop only, normalization
// deferred to the device — the store's uint8 H2D wire, sae/store.py).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <numeric>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <cstdio>

extern "C" {
// from image_pipeline.cpp (same shared library)
int ip_decode_jpeg(const uint8_t* data, long len, uint8_t** out,
                   int* h, int* w);
int ip_preprocess_rgb(const uint8_t* in, int h, int w, int c, int out_size,
                      const float* mean, const float* stdv, float* out_chw);
void ip_free(void* p);
}

namespace {

struct Loader {
    std::vector<std::string> paths;
    int batch, out_size, depth;
    bool u8_wire;
    float mean[3], stdv[3];
    unsigned long long seed;
    size_t item_bytes;                       // one image in the slot buffer
    std::vector<std::vector<uint8_t>> slots; // depth x (batch * item_bytes)

    std::mutex mu;
    std::condition_variable cv_free, cv_ready;
    std::queue<int> free_slots;
    std::queue<int> ready;
    long next_batch = 0;                     // producer-side batch counter
    std::atomic<long> decode_failures{0};
    std::atomic<bool> stop{false};
    std::vector<std::thread> workers;

    std::mutex perm_mu;
    // epoch -> permutation, shared_ptr-held: a worker keeps its epoch's
    // permutation alive through its batch even after the cache evicts it
    // (small datasets let in-flight batches straddle many epochs)
    std::map<long, std::shared_ptr<const std::vector<long>>> perms;

    long batches_per_epoch() const {
        return static_cast<long>(paths.size()) / batch;  // drop_last
    }

    std::shared_ptr<const std::vector<long>> perm_for(long epoch) {
        std::lock_guard<std::mutex> g(perm_mu);
        auto it = perms.find(epoch);
        if (it == perms.end()) {
            auto p = std::make_shared<std::vector<long>>(paths.size());
            std::iota(p->begin(), p->end(), 0L);
            std::mt19937_64 rng(seed + static_cast<unsigned long long>(epoch));
            std::shuffle(p->begin(), p->end(), rng);
            it = perms.emplace(epoch, std::move(p)).first;
            while (perms.size() > 2) perms.erase(perms.begin());
        }
        return it->second;
    }
};

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize(n > 0 ? static_cast<size_t>(n) : 0);
    bool ok = n >= 0 &&
        std::fread(out.data(), 1, out.size(), f) == out.size();
    std::fclose(f);
    return ok;
}

// Decode one file and write it at `dst` inside a slot buffer.  Unreadable
// or undecodable files produce a zero image (the run keeps going — the
// reference's loader would raise mid-epoch instead).
void load_one(Loader& L, const std::string& path, uint8_t* dst,
              std::vector<uint8_t>& filebuf, std::vector<float>& f32buf) {
    const int S = L.out_size;
    uint8_t* rgb = nullptr;
    int h = 0, w = 0;
    bool ok = read_file(path, filebuf) && !filebuf.empty() &&
        ip_decode_jpeg(filebuf.data(), (long)filebuf.size(), &rgb, &h, &w)
            == 0;
    if (!ok) {
        // zero image + visible failure: the consumer can query
        // ip_loader_failures and the run log shows the path (the Python
        // fallback would decode e.g. PNGs via PIL — route only JPEGs here)
        L.decode_failures.fetch_add(1);
        std::fprintf(stderr, "batch_loader: failed to read/decode %s\n",
                     path.c_str());
        std::memset(dst, 0, L.item_bytes);
        if (rgb) ip_free(rgb);
        return;
    }
    if (L.u8_wire) {
        // resize+crop via the float pipeline with identity normalization
        // (mean 0, std 1/255 -> float equals the resized pixel value),
        // then round to uint8
        const float zero3[3] = {0.f, 0.f, 0.f};
        const float inv255[3] = {1.f / 255.f, 1.f / 255.f, 1.f / 255.f};
        f32buf.resize(static_cast<size_t>(3) * S * S);
        ip_preprocess_rgb(rgb, h, w, 3, S, zero3, inv255, f32buf.data());
        for (size_t i = 0; i < f32buf.size(); ++i) {
            float v = f32buf[i] + 0.5f;
            dst[i] = static_cast<uint8_t>(v < 0.f ? 0 : v > 255.f ? 255 : v);
        }
    } else {
        ip_preprocess_rgb(rgb, h, w, 3, S, L.mean, L.stdv,
                          reinterpret_cast<float*>(dst));
    }
    ip_free(rgb);
}

void worker_loop(Loader* L) {
    std::vector<uint8_t> filebuf;
    std::vector<float> f32buf;
    const long per_epoch = L->batches_per_epoch();
    while (!L->stop.load()) {
        int slot;
        long b;
        {
            std::unique_lock<std::mutex> lk(L->mu);
            L->cv_free.wait(lk, [&] {
                return L->stop.load() || !L->free_slots.empty();
            });
            if (L->stop.load()) return;
            slot = L->free_slots.front();
            L->free_slots.pop();
            b = L->next_batch++;
        }
        const long epoch = b / per_epoch;
        const long off = (b % per_epoch) * L->batch;
        const auto perm = L->perm_for(epoch);  // shared_ptr: eviction-safe
        uint8_t* base = L->slots[slot].data();
        for (int i = 0; i < L->batch; ++i)
            load_one(*L, L->paths[(*perm)[off + i]],
                     base + static_cast<size_t>(i) * L->item_bytes,
                     filebuf, f32buf);
        {
            std::lock_guard<std::mutex> g(L->mu);
            L->ready.push(slot);
        }
        L->cv_ready.notify_one();
    }
}

}  // namespace

extern "C" {

void* ip_loader_create(const char** paths, long n_items, int batch_size,
                       int out_size, const float* mean, const float* stdv,
                       int n_workers, int queue_depth,
                       unsigned long long seed, int uint8_wire) {
    if (n_items < batch_size || batch_size <= 0 || out_size <= 0 ||
        n_workers <= 0 || queue_depth <= 0)
        return nullptr;
    auto* L = new Loader();
    L->paths.reserve(n_items);
    for (long i = 0; i < n_items; ++i) L->paths.emplace_back(paths[i]);
    L->batch = batch_size;
    L->out_size = out_size;
    L->depth = queue_depth;
    L->u8_wire = uint8_wire != 0;
    for (int i = 0; i < 3; ++i) {
        L->mean[i] = mean ? mean[i] : 0.f;
        L->stdv[i] = stdv ? stdv[i] : 1.f;
    }
    L->seed = seed;
    L->item_bytes = static_cast<size_t>(3) * out_size * out_size *
        (L->u8_wire ? 1 : 4);
    L->slots.resize(queue_depth);
    for (int s = 0; s < queue_depth; ++s) {
        L->slots[s].resize(static_cast<size_t>(batch_size) * L->item_bytes);
        L->free_slots.push(s);
    }
    for (int t = 0; t < n_workers; ++t)
        L->workers.emplace_back(worker_loop, L);
    return L;
}

// Copies the next ready batch ([batch, 3, out, out] float32 or uint8 per
// `uint8_wire`) into `out`.  Blocks until one is available.  Returns 0.
int ip_loader_next(void* handle, void* out) {
    auto* L = static_cast<Loader*>(handle);
    int slot;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [&] { return !L->ready.empty(); });
        slot = L->ready.front();
        L->ready.pop();
    }
    std::memcpy(out, L->slots[slot].data(),
                static_cast<size_t>(L->batch) * L->item_bytes);
    {
        std::lock_guard<std::mutex> g(L->mu);
        L->free_slots.push(slot);
    }
    L->cv_free.notify_one();
    return 0;
}

long ip_loader_failures(void* handle) {
    return static_cast<Loader*>(handle)->decode_failures.load();
}

void ip_loader_destroy(void* handle) {
    auto* L = static_cast<Loader*>(handle);
    L->stop.store(true);
    L->cv_free.notify_all();
    L->cv_ready.notify_all();
    for (auto& t : L->workers) t.join();
    delete L;
}

}  // extern "C"
