// gnuradio_tpu native host runtime.
//
// The device compute path is jitted XLA; this library is the native runtime
// AROUND it — the analog of the reference's C++ runtime pieces that remain
// host-side work in an accelerator design:
//
//   * vm_ringbuf: single-writer/single-reader circular buffer whose physical
//     pages are mapped TWICE back-to-back in virtual memory, so every
//     contiguous window [read, read+n) is linear even across the wrap —
//     the same double-mapping trick as the reference's vmcircbuf
//     (gnuradio-runtime/lib/vmcircbuf_mmap_shm_open.cc:71-118), built on
//     memfd_create here. Used to stage sample streams between the reader
//     thread and the device-feed thread with zero copies.
//
//   * iq_reader: a background pthread that streams an IQ capture file
//     through format conversion (ci8 / ci16 / cf32 interleaved -> float32
//     re/im planes, the runtime's host-encode layout) into a vm_ringbuf.
//     This replaces the reference's file_source + type-convert blocks
//     (gr-blocks/lib/file_source_impl.cc, interleaved_short_to_complex)
//     with one prefetching native pipeline feeding jax.device_put.
//
//   * converters: tight loops the compiler auto-vectorizes (the VOLK-kernel
//     role for host-side work).
//
// Plain C ABI (extern "C") for ctypes binding — no pybind11 dependency.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

static long page_size() { return sysconf(_SC_PAGESIZE); }

struct VmRingbuf {
    uint8_t* base = nullptr;  // 2*size mapping
    size_t size = 0;          // bytes of real storage (page multiple)
    int fd = -1;
    std::atomic<uint64_t> wr{0};  // absolute bytes written
    std::atomic<uint64_t> rd{0};  // absolute bytes read
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// vm_ringbuf
// ---------------------------------------------------------------------------

VmRingbuf* vmrb_create(size_t min_size) {
    long pg = page_size();
    size_t size = ((min_size + pg - 1) / pg) * pg;
    int fd = memfd_create("grtpu_vmrb", 0);
    if (fd < 0) return nullptr;
    if (ftruncate(fd, (off_t)size) != 0) {
        close(fd);
        return nullptr;
    }
    // Reserve 2*size of address space, then map the fd twice into it.
    uint8_t* base = (uint8_t*)mmap(nullptr, 2 * size, PROT_NONE,
                                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (base == MAP_FAILED) {
        close(fd);
        return nullptr;
    }
    void* a = mmap(base, size, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_FIXED, fd, 0);
    void* b = mmap(base + size, size, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_FIXED, fd, 0);
    if (a == MAP_FAILED || b == MAP_FAILED) {
        munmap(base, 2 * size);
        close(fd);
        return nullptr;
    }
    auto* rb = new VmRingbuf();
    rb->base = base;
    rb->size = size;
    rb->fd = fd;
    return rb;
}

void vmrb_destroy(VmRingbuf* rb) {
    if (!rb) return;
    munmap(rb->base, 2 * rb->size);
    close(rb->fd);
    delete rb;
}

size_t vmrb_size(VmRingbuf* rb) { return rb->size; }

size_t vmrb_space_available(VmRingbuf* rb) {
    return rb->size - (size_t)(rb->wr.load(std::memory_order_acquire) -
                               rb->rd.load(std::memory_order_acquire));
}

size_t vmrb_items_available(VmRingbuf* rb) {
    return (size_t)(rb->wr.load(std::memory_order_acquire) -
                    rb->rd.load(std::memory_order_acquire));
}

// Linear write pointer: always size-contiguous thanks to the double map.
uint8_t* vmrb_write_ptr(VmRingbuf* rb) {
    return rb->base + (rb->wr.load(std::memory_order_relaxed) % rb->size);
}

uint8_t* vmrb_read_ptr(VmRingbuf* rb) {
    return rb->base + (rb->rd.load(std::memory_order_relaxed) % rb->size);
}

void vmrb_produce(VmRingbuf* rb, size_t n) {
    rb->wr.fetch_add(n, std::memory_order_release);
}

void vmrb_consume(VmRingbuf* rb, size_t n) {
    rb->rd.fetch_add(n, std::memory_order_release);
}

// Self-test of the double mapping (the vmcircbuf_sysconfig self-test analog,
// gnuradio-runtime/lib/vmcircbuf.cc): write a pattern across the wrap
// boundary through the first mapping and verify it reads back linearly.
int vmrb_selftest(void) {
    VmRingbuf* rb = vmrb_create(1 << 16);
    if (!rb) return -1;
    size_t sz = rb->size;
    // advance to near the end so a write wraps
    rb->wr.store(sz - 128);
    rb->rd.store(sz - 128);
    uint8_t* w = vmrb_write_ptr(rb);
    for (int i = 0; i < 4096; i++) w[i] = (uint8_t)(i * 37 + 11);
    vmrb_produce(rb, 4096);
    uint8_t* r = vmrb_read_ptr(rb);
    int ok = 0;
    for (int i = 0; i < 4096; i++)
        if (r[i] != (uint8_t)(i * 37 + 11)) ok = -2;
    // the wrapped portion must alias the start of the first mapping
    if (memcmp(rb->base, rb->base + sz, 4096) != 0) ok = -3;
    vmrb_destroy(rb);
    return ok;
}

// ---------------------------------------------------------------------------
// converters: interleaved IQ -> float32 re/im planes (host-encode layout)
// ---------------------------------------------------------------------------

void conv_ci8_to_planes(const int8_t* in, float* re, float* im, size_t n,
                        float scale) {
    for (size_t i = 0; i < n; i++) {
        re[i] = (float)in[2 * i] * scale;
        im[i] = (float)in[2 * i + 1] * scale;
    }
}

void conv_ci16_to_planes(const int16_t* in, float* re, float* im, size_t n,
                         float scale) {
    for (size_t i = 0; i < n; i++) {
        re[i] = (float)in[2 * i] * scale;
        im[i] = (float)in[2 * i + 1] * scale;
    }
}

void conv_cf32_to_planes(const float* in, float* re, float* im, size_t n,
                         float scale) {
    for (size_t i = 0; i < n; i++) {
        re[i] = in[2 * i] * scale;
        im[i] = in[2 * i + 1] * scale;
    }
}

void conv_planes_to_ci16(const float* re, const float* im, int16_t* out,
                         size_t n, float scale) {
    for (size_t i = 0; i < n; i++) {
        float a = re[i] * scale, b = im[i] * scale;
        if (a > 32767.f) a = 32767.f;
        if (a < -32768.f) a = -32768.f;
        if (b > 32767.f) b = 32767.f;
        if (b < -32768.f) b = -32768.f;
        out[2 * i] = (int16_t)a;
        out[2 * i + 1] = (int16_t)b;
    }
}

// ---------------------------------------------------------------------------
// iq_reader: background file -> ringbuf of float32 planes
// ---------------------------------------------------------------------------

namespace {

enum IqFormat : int { IQ_CI8 = 0, IQ_CI16 = 1, IQ_CF32 = 2 };

struct IqReader {
    VmRingbuf* rb = nullptr;   // holds [re-plane chunk | im-plane chunk]...
    FILE* f = nullptr;
    int fmt = IQ_CF32;
    size_t chunk_items = 0;    // complex samples per chunk
    float scale = 1.0f;
    std::atomic<bool> done{false};
    std::atomic<bool> stop{false};
    std::thread th;
    std::vector<uint8_t> readbuf;
};

static size_t bytes_per_item(int fmt) {
    switch (fmt) {
        case IQ_CI8: return 2;
        case IQ_CI16: return 4;
        default: return 8;
    }
}

static void reader_loop(IqReader* r) {
    const size_t chunk_bytes = r->chunk_items * 2 * sizeof(float);
    const size_t in_bytes = r->chunk_items * bytes_per_item(r->fmt);
    r->readbuf.resize(in_bytes);
    while (!r->stop.load()) {
        if (vmrb_space_available(r->rb) < chunk_bytes) {
            std::this_thread::yield();
            continue;
        }
        size_t got = fread(r->readbuf.data(), 1, in_bytes, r->f);
        size_t items = got / bytes_per_item(r->fmt);
        if (items == 0) break;
        float* re = (float*)vmrb_write_ptr(r->rb);
        float* im = re + r->chunk_items;
        if (items < r->chunk_items) {  // zero-pad the final partial chunk
            memset(re, 0, chunk_bytes);
        }
        switch (r->fmt) {
            case IQ_CI8:
                conv_ci8_to_planes((const int8_t*)r->readbuf.data(), re, im,
                                   items, r->scale);
                break;
            case IQ_CI16:
                conv_ci16_to_planes((const int16_t*)r->readbuf.data(), re, im,
                                    items, r->scale);
                break;
            default:
                conv_cf32_to_planes((const float*)r->readbuf.data(), re, im,
                                    items, r->scale);
        }
        vmrb_produce(r->rb, chunk_bytes);
        if (items < r->chunk_items) break;
    }
    r->done.store(true);
}

}  // namespace

IqReader* iqr_open(const char* path, int fmt, size_t chunk_items,
                   float scale, size_t ring_chunks) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    auto* r = new IqReader();
    r->f = f;
    r->fmt = fmt;
    r->chunk_items = chunk_items;
    r->scale = scale;
    size_t chunk_bytes = chunk_items * 2 * sizeof(float);
    r->rb = vmrb_create(chunk_bytes * (ring_chunks < 2 ? 2 : ring_chunks));
    if (!r->rb) {
        fclose(f);
        delete r;
        return nullptr;
    }
    r->th = std::thread(reader_loop, r);
    return r;
}

// Returns pointer to a contiguous [2*chunk_items] float block (re plane then
// im plane), or nullptr if not ready yet / finished. Caller must call
// iqr_release after copying.
float* iqr_next(IqReader* r) {
    size_t chunk_bytes = r->chunk_items * 2 * sizeof(float);
    if (vmrb_items_available(r->rb) >= chunk_bytes)
        return (float*)vmrb_read_ptr(r->rb);
    if (r->done.load()) return nullptr;
    return (float*)-1;  // try again
}

void iqr_release(IqReader* r) {
    vmrb_consume(r->rb, r->chunk_items * 2 * sizeof(float));
}

int iqr_finished(IqReader* r) {
    size_t chunk_bytes = r->chunk_items * 2 * sizeof(float);
    return r->done.load() && vmrb_items_available(r->rb) < chunk_bytes;
}

void iqr_close(IqReader* r) {
    if (!r) return;
    r->stop.store(true);
    if (r->th.joinable()) r->th.join();
    fclose(r->f);
    vmrb_destroy(r->rb);
    delete r;
}

// ---------------------------------------------------------------------------
// udp_rx: background UDP datagram receiver -> vm_ringbuf (raw payload bytes).
// The native analog of gr-network's udp_source (C++ receive thread +
// buffering in the reference, gr-network/lib/udp_source_impl.cc): datagrams
// drain into the double-mapped ring regardless of Python/GIL activity;
// the host runner slices fixed chunks for device_put.
// ---------------------------------------------------------------------------

struct UdpRx {
    int sock = -1;
    VmRingbuf* rb = nullptr;
    std::thread th;
    std::atomic<int> stop{0};
    std::atomic<uint64_t> dropped{0};  // bytes dropped on ring overflow
};

static void udp_rx_loop(UdpRx* u) {
    std::vector<uint8_t> pkt(65536);
    while (!u->stop.load(std::memory_order_relaxed)) {
        ssize_t n = recv(u->sock, pkt.data(), pkt.size(), 0);
        if (n <= 0) {
            if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) continue;
            if (u->stop.load(std::memory_order_relaxed)) break;
            continue;
        }
        size_t space = u->rb->size -
            (u->rb->wr.load(std::memory_order_relaxed) -
             u->rb->rd.load(std::memory_order_acquire));
        if ((size_t)n > space) {
            u->dropped.fetch_add((uint64_t)n, std::memory_order_relaxed);
            continue;  // drop whole datagrams on overflow (UDP semantics)
        }
        uint64_t wr = u->rb->wr.load(std::memory_order_relaxed);
        memcpy(u->rb->base + (wr % u->rb->size), pkt.data(), (size_t)n);
        u->rb->wr.store(wr + (uint64_t)n, std::memory_order_release);
    }
}

UdpRx* udprx_start(const char* bind_addr, int port, size_t ring_bytes) {
    int sock = socket(AF_INET, SOCK_DGRAM, 0);
    if (sock < 0) return nullptr;
    int one = 1;
    setsockopt(sock, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    struct timeval tv { 0, 100000 };  // 100 ms poll so stop is responsive
    setsockopt(sock, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr {};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    addr.sin_addr.s_addr = bind_addr && *bind_addr
        ? inet_addr(bind_addr) : htonl(INADDR_LOOPBACK);
    if (bind(sock, (sockaddr*)&addr, sizeof(addr)) != 0) {
        close(sock);
        return nullptr;
    }
    VmRingbuf* rb = vmrb_create(ring_bytes);
    if (!rb) {
        close(sock);
        return nullptr;
    }
    auto* u = new UdpRx();
    u->sock = sock;
    u->rb = rb;
    u->th = std::thread(udp_rx_loop, u);
    return u;
}

size_t udprx_available(UdpRx* u) { return vmrb_items_available(u->rb); }

size_t udprx_read(UdpRx* u, uint8_t* out, size_t n) {
    size_t avail = vmrb_items_available(u->rb);
    if (n > avail) n = avail;
    memcpy(out, vmrb_read_ptr(u->rb), n);
    vmrb_consume(u->rb, n);
    return n;
}

uint64_t udprx_dropped(UdpRx* u) {
    return u->dropped.load(std::memory_order_relaxed);
}

void udprx_stop(UdpRx* u) {
    u->stop.store(1);
    if (u->th.joinable()) u->th.join();
    close(u->sock);
    vmrb_destroy(u->rb);
    delete u;
}

}  // extern "C"
