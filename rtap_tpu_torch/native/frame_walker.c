/* Native frame walker for the RB1 binary batch ingest protocol
 * (rtap_tpu_torch/ingest/protocol.py owns the format).
 *
 * The socket drain path hands each recv() chunk to one scan call: it
 * delimits complete frames, validates magic/reserved/count sanity and
 * the trailing crc32, resyncs over garbage to the next magic, and
 * reports per-frame header fields back as int64 tuples — so the Python
 * side touches one object per FRAME (thousands of rows), never per
 * byte. Semantics are pinned 1:1 against the pure-Python fallback
 * (protocol.scan_frames_py) by tests/test_torch_ingest_protocol.py; any
 * divergence is a bug here.
 *
 * Same build/fallback discipline as jsonl_parser.c: compiled on demand
 * by rtap_tpu_torch/native/__init__.py, and callers treat a load failure as
 * "native path unavailable" (pure-Python walker takes over).
 */

#include <stdint.h>
#include <string.h>

#define HEADER_SIZE 20
#define CRC_SIZE 4
#define ROW_SIZE 10
#define KIND_DATA 1
#define KIND_NAMES 2
#define KIND_MAP 3
#define PROTOCOL_VERSION 1
#define MAX_DATA_ROWS (1LL << 22)
#define MAX_BLOB_BYTES (16LL << 20)

static uint32_t load_u32(const unsigned char *p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

static int64_t load_i64(const unsigned char *p) {
    uint64_t v = 0;
    for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
    return (int64_t)v;
}

/* zlib-compatible CRC-32 (IEEE reflected, init/final xor 0xffffffff),
 * eight bytes per step over eight derived tables ("slicing-by-8"): the
 * same values as the byte-at-a-time loop, ~4x fewer dependent steps per
 * byte — the CRC is the scan's main cost on a binary-ingest payload */
static uint32_t crc_table[8][256];
static int crc_ready = 0;

static void crc_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
        crc_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = crc_table[0][i];
        for (int t = 1; t < 8; t++) {
            c = crc_table[0][c & 0xffu] ^ (c >> 8);
            crc_table[t][i] = c;
        }
    }
    crc_ready = 1;
}

static uint32_t crc32_calc(const unsigned char *p, long long n) {
    if (!crc_ready) crc_init();
    uint32_t c = 0xffffffffu;
    for (; n >= 8; p += 8, n -= 8) {
        uint32_t lo = load_u32(p) ^ c, hi = load_u32(p + 4);
        c = crc_table[7][lo & 0xffu] ^ crc_table[6][(lo >> 8) & 0xffu] ^
            crc_table[5][(lo >> 16) & 0xffu] ^ crc_table[4][lo >> 24] ^
            crc_table[3][hi & 0xffu] ^ crc_table[2][(hi >> 8) & 0xffu] ^
            crc_table[1][(hi >> 16) & 0xffu] ^ crc_table[0][hi >> 24];
    }
    for (; n > 0; p++, n--)
        c = crc_table[0][(c ^ *p) & 0xffu] ^ (c >> 8);
    return c ^ 0xffffffffu;
}

/* next occurrence of "RB1" at/after pos, or -1 */
static long long find_magic(const unsigned char *buf, long long n,
                            long long pos) {
    for (long long i = pos; i + 3 <= n; i++) {
        if (buf[i] == 'R' && buf[i + 1] == 'B' && buf[i + 2] == '1')
            return i;
    }
    return -1;
}

/* Scan buf for complete frames.
 *
 * out: up to out_cap frames x 8 int64s each:
 *      [kind, version, epoch, tenant_off, tenant_len, count, base_ts,
 *       payload_off]
 * stats: int64[4] — [garbage_bytes, bad_crc, version_skew, consumed]
 *        (accumulated into, caller zeroes; consumed is SET).
 * Returns the number of frames written (scan stops early at out_cap —
 * the Python wrapper loops on the unconsumed remainder).
 */
long long rtap_fw_scan(const unsigned char *buf, long long n,
                       int64_t *out, long long out_cap, int64_t *stats) {
    long long off = 0, emitted = 0;
    while (off + HEADER_SIZE <= n && emitted < out_cap) {
        if (!(buf[off] == 'R' && buf[off + 1] == 'B' &&
              buf[off + 2] == '1')) {
            long long nxt = find_magic(buf, n, off + 1);
            long long skip_to = nxt >= 0 ? nxt
                                         : (n - 2 > off + 1 ? n - 2 : off + 1);
            stats[0] += skip_to - off;
            off = skip_to;
            continue;
        }
        int version = buf[off + 3];
        int kind = buf[off + 4];
        int tlen = buf[off + 5];
        uint32_t epoch = (uint32_t)buf[off + 6] |
                         ((uint32_t)buf[off + 7] << 8);
        int64_t count = (int64_t)load_u32(buf + off + 8);
        int64_t base_ts = load_i64(buf + off + 12);
        int sane = (kind == KIND_DATA ? count <= MAX_DATA_ROWS
                                      : count <= MAX_BLOB_BYTES);
        if (!sane) {
            long long nxt = find_magic(buf, n, off + 1);
            long long skip_to = nxt >= 0 ? nxt
                                         : (n - 2 > off + 1 ? n - 2 : off + 1);
            stats[0] += skip_to - off;
            off = skip_to;
            continue;
        }
        int64_t payload = kind == KIND_DATA ? count * ROW_SIZE : count;
        long long end = off + HEADER_SIZE + tlen + payload + CRC_SIZE;
        if (end > n) break; /* torn tail: wait for more bytes */
        uint32_t crc = load_u32(buf + end - CRC_SIZE);
        if (crc != crc32_calc(buf + off + 3,
                              end - CRC_SIZE - (off + 3))) {
            stats[1] += 1;
            long long nxt = find_magic(buf, n, off + 1);
            long long skip_to = nxt >= 0 ? nxt
                                         : (n - 2 > off + 1 ? n - 2 : off + 1);
            stats[0] += skip_to - off;
            off = skip_to;
            continue;
        }
        if (version != PROTOCOL_VERSION ||
            (kind != KIND_DATA && kind != KIND_NAMES && kind != KIND_MAP)) {
            /* framing fields are frozen across versions: skip whole,
             * counted — forward compatibility, not corruption */
            stats[2] += 1;
            off = end;
            continue;
        }
        int64_t *m = out + emitted * 8;
        m[0] = kind;
        m[1] = version;
        m[2] = (int64_t)epoch;
        m[3] = off + HEADER_SIZE;
        m[4] = tlen;
        m[5] = count;
        m[6] = base_ts;
        m[7] = off + HEADER_SIZE + tlen;
        emitted++;
        off = end;
    }
    stats[3] = off;
    return emitted;
}
