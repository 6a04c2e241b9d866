/* Native JSONL metrics parser for the TCP push collector (SURVEY.md C18).
 *
 * The reference's collector normalizes per-node stats into (node, metric,
 * t, value) tuples on the host; at the 100k-streams-per-chip north star the
 * push listener must parse ~100k records/s on a host core that is also
 * driving the device and computing likelihoods. The pure-Python hot path
 * (json.loads + dict lookup + per-record lock) costs microseconds per
 * record; this module does the whole drain in C: scan a raw recv() chunk,
 * extract the {"id", "value", "ts"} fields of each line, resolve the id
 * against a precomputed open-addressing hash table, and write the latest
 * value per stream straight into the caller-owned float32 array.
 *
 * Scope (documented, tested): this is a schema parser for flat JSONL
 * metric records, not a general JSON validator. Fields may appear in any
 * order; unknown extra fields are skipped token-wise; strings honor
 * backslash escapes for delimiter purposes but ids are matched on their
 * raw (unescaped) bytes; values accept numbers, quoted numbers, true/
 * false, and NaN/Infinity (the Python json module accepts those too).
 * Records that fail schema extraction count as parse errors; structurally
 * deeper divergences from strict JSON (e.g. trailing garbage after the
 * fields we need) are accepted here but rejected by the Python fallback —
 * the parity tests pin both parsers on the realistic record space.
 *
 * Concurrency: one Parser per connection (it owns that connection's
 * partial-line remainder); the output arrays are shared and the caller
 * serializes feed() calls with its own lock (one lock per chunk, not per
 * record — part of the win).
 */

#include <ctype.h>
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_LINE 65536          /* longer lines: parse_error + resync    */
#define COUNTER_PARSED 0
#define COUNTER_PARSE_ERRORS 1
#define COUNTER_UNKNOWN_IDS 2

/* ------------------------------------------------------------------ hash */

/* FNV-1a over raw id bytes: ids are short metric names; the table is
 * built once per listener and only probed afterwards. */
static uint64_t fnv1a(const char *s, long n) {
    uint64_t h = 1469598103934665603ULL;
    for (long i = 0; i < n; i++) {
        h ^= (unsigned char)s[i];
        h *= 1099511628211ULL;
    }
    return h;
}

typedef struct {
    char **keys;     /* owned copies of id bytes        */
    int *key_lens;
    int32_t *vals;   /* stream index                    */
    long cap;        /* power of two                    */
    long n;
} Table;

static Table *table_new(long n_ids) {
    Table *t = (Table *)calloc(1, sizeof(Table));
    if (!t) return NULL;
    long cap = 16;
    while (cap < n_ids * 2) cap <<= 1;   /* load factor <= 0.5 */
    t->cap = cap;
    t->keys = (char **)calloc((size_t)cap, sizeof(char *));
    t->key_lens = (int *)calloc((size_t)cap, sizeof(int));
    t->vals = (int32_t *)calloc((size_t)cap, sizeof(int32_t));
    if (!t->keys || !t->key_lens || !t->vals) return NULL;
    return t;
}

static void table_free(Table *t) {
    if (!t) return;
    for (long i = 0; i < t->cap; i++) free(t->keys[i]);
    free(t->keys);
    free(t->key_lens);
    free(t->vals);
    free(t);
}

static int table_put(Table *t, const char *key, int len, int32_t val) {
    uint64_t h = fnv1a(key, len);
    for (long i = 0; i < t->cap; i++) {
        long slot = (long)((h + (uint64_t)i) & (uint64_t)(t->cap - 1));
        if (t->keys[slot] == NULL) {
            t->keys[slot] = (char *)malloc((size_t)len);
            if (!t->keys[slot]) return -1;
            memcpy(t->keys[slot], key, (size_t)len);
            t->key_lens[slot] = len;
            t->vals[slot] = val;
            t->n++;
            return 0;
        }
        if (t->key_lens[slot] == len && memcmp(t->keys[slot], key, (size_t)len) == 0) {
            t->vals[slot] = val;  /* duplicate id: last wins, like dict */
            return 0;
        }
    }
    return -1;
}

static int32_t table_get(const Table *t, const char *key, long len) {
    if (len > INT32_MAX) return -1;
    uint64_t h = fnv1a(key, len);
    for (long i = 0; i < t->cap; i++) {
        long slot = (long)((h + (uint64_t)i) & (uint64_t)(t->cap - 1));
        if (t->keys[slot] == NULL) return -1;
        if (t->key_lens[slot] == (int)len &&
            memcmp(t->keys[slot], key, (size_t)len) == 0)
            return t->vals[slot];
    }
    return -1;
}

/* ---------------------------------------------------------------- parser */

typedef struct {
    Table **table_ref;   /* shared indirection: the owner can swap the
                            table (dynamic membership, set_ids) and every
                            per-connection clone observes the new one on
                            its next line — the caller's listener lock
                            serializes feeds against the swap */
    int owns_ref;
    char rem[MAX_LINE];  /* partial trailing line from the previous chunk */
    long rem_len;
    int rem_overflow;    /* current line exceeded MAX_LINE: swallow to \n */
} Parser;

static Table *build_table(const char *ids_blob, const int32_t *id_lens,
                          int32_t n_ids) {
    Table *t = table_new(n_ids > 0 ? n_ids : 1);
    if (!t) return NULL;
    const char *cur = ids_blob;
    for (int32_t i = 0; i < n_ids; i++) {
        if (table_put(t, cur, id_lens[i], i) != 0) {
            table_free(t);
            return NULL;
        }
        cur += id_lens[i];
    }
    return t;
}

Parser *rtap_parser_new(const char *ids_blob, const int32_t *id_lens, int32_t n_ids) {
    Parser *p = (Parser *)calloc(1, sizeof(Parser));
    if (!p) return NULL;
    p->table_ref = (Table **)calloc(1, sizeof(Table *));
    if (!p->table_ref) { free(p); return NULL; }
    *p->table_ref = build_table(ids_blob, id_lens, n_ids);
    if (!*p->table_ref) { free(p->table_ref); free(p); return NULL; }
    p->owns_ref = 1;
    return p;
}

/* Swap the owner's id table (registry membership changed). The caller must
 * hold the same lock that serializes feed()/flush() — no parser may be
 * mid-line-batch during the swap. Returns 0, -1 on allocation failure
 * (the old table stays in place). */
int rtap_parser_set_table(Parser *owner, const char *ids_blob,
                          const int32_t *id_lens, int32_t n_ids) {
    Table *fresh = build_table(ids_blob, id_lens, n_ids);
    if (!fresh) return -1;
    table_free(*owner->table_ref);
    *owner->table_ref = fresh;
    return 0;
}

/* Share one listener-wide table across per-connection parsers. */
Parser *rtap_parser_clone(const Parser *src) {
    Parser *p = (Parser *)calloc(1, sizeof(Parser));
    if (!p) return NULL;
    p->table_ref = src->table_ref;   /* borrowed: freed only by the owner */
    return p;
}

void rtap_parser_free_clone(Parser *p) { free(p); }

void rtap_parser_free_owner(Parser *p) {
    if (!p) return;
    if (p->owns_ref) {
        table_free(*p->table_ref);
        free(p->table_ref);
    }
    free(p);
}

/* -- line-level field scanner -------------------------------------------- */

/* Skip a JSON string starting at s (s[0]=='"'); returns pointer past the
 * closing quote, or NULL if unterminated before end. */
static const char *skip_string(const char *s, const char *end) {
    s++;
    while (s < end) {
        if (*s == '\\') { s += 2; continue; }
        if (*s == '"') return s + 1;
        s++;
    }
    return NULL;
}

static const char *skip_ws(const char *s, const char *end) {
    while (s < end && (*s == ' ' || *s == '\t' || *s == '\r')) s++;
    return s;
}

/* Field slots extracted from one record. */
typedef struct {
    const char *id;   long id_len;   int has_id;
    const char *val;  long val_len;  int has_val;  int val_quoted;
    const char *ts;   long ts_len;   int has_ts;   int ts_quoted;
} Fields;

/* Scan one line's top-level "key": value pairs. Returns 0 on schema
 * success (structure walkable), -1 on malformed structure. */
static int scan_line(const char *s, const char *end, Fields *f) {
    memset(f, 0, sizeof(*f));
    s = skip_ws(s, end);
    if (s >= end || *s != '{') return -1;
    s++;
    for (;;) {
        s = skip_ws(s, end);
        if (s < end && *s == '}') return 0;
        if (s >= end || *s != '"') return -1;
        const char *kstart = s + 1;
        const char *kend_q = skip_string(s, end);
        if (!kend_q) return -1;
        const char *kend = kend_q - 1;  /* closing quote */
        s = skip_ws(kend_q, end);
        if (s >= end || *s != ':') return -1;
        s = skip_ws(s + 1, end);
        if (s >= end) return -1;

        const char *vstart = s;
        const char *vend;
        int quoted = 0;
        if (*s == '"') {
            quoted = 1;
            vend = skip_string(s, end);
            if (!vend) return -1;
        } else if (*s == '{' || *s == '[') {
            /* nested value: skip balanced, honoring strings */
            int depth = 0;
            const char *q = s;
            while (q < end) {
                if (*q == '"') {
                    q = skip_string(q, end);
                    if (!q) return -1;
                    continue;
                }
                if (*q == '{' || *q == '[') depth++;
                else if (*q == '}' || *q == ']') {
                    depth--;
                    if (depth == 0) { q++; break; }
                }
                q++;
            }
            if (depth != 0) return -1;
            vend = q;
        } else {
            vend = s;
            while (vend < end && *vend != ',' && *vend != '}' &&
                   *vend != ' ' && *vend != '\t' && *vend != '\r')
                vend++;
            if (vend == s) return -1;
        }

        long klen = kend - kstart;
        const char *vs = quoted ? vstart + 1 : vstart;
        long vlen = quoted ? (vend - 1) - (vstart + 1) : vend - vstart;
        if (klen == 2 && memcmp(kstart, "id", 2) == 0) {
            f->id = vs; f->id_len = vlen;
            /* 1 = string (lookup on raw bytes); 2 = non-string scalar
             * (hashable: dict.get(5) misses -> unknown); 3 = object/array
             * (unhashable: dict.get raises TypeError -> parse_error) */
            f->has_id = quoted ? 1 : (*vstart == '{' || *vstart == '[') ? 3 : 2;
        } else if (klen == 5 && memcmp(kstart, "value", 5) == 0) {
            f->val = vs; f->val_len = vlen; f->has_val = 1; f->val_quoted = quoted;
        } else if (klen == 2 && memcmp(kstart, "ts", 2) == 0) {
            f->ts = vs; f->ts_len = vlen; f->has_ts = 1; f->ts_quoted = quoted;
        }

        s = skip_ws(vend, end);
        if (s < end && *s == ',') { s++; continue; }
        if (s < end && *s == '}') return 0;
        return -1;
    }
}

/* Parse a number token (optionally the inside of a quoted string) the way
 * the Python path does (np.float32(x)): strtod handles inf/nan spellings;
 * true/false/null follow np.float32(True/False) and reject None; hex is
 * rejected (strtod accepts C99 hex floats, np.float32(str)/json.loads do
 * not). Returns 0 ok. */
static int token_to_double(const char *s, long n, double *out) {
    if (n <= 0 || n >= 64) return -1;
    char buf[64];
    memcpy(buf, s, (size_t)n);
    buf[n] = 0;
    if (strcmp(buf, "true") == 0) { *out = 1.0; return 0; }
    if (strcmp(buf, "false") == 0) { *out = 0.0; return 0; }
    if (strcmp(buf, "null") == 0) return -1;
    for (long i = 0; i < n; i++)
        if (buf[i] == 'x' || buf[i] == 'X') return -1;  /* no hex floats */
    char *endp = NULL;
    double v = strtod(buf, &endp);
    if (endp == buf) return -1;
    while (*endp == ' ') endp++;
    if (*endp != 0) return -1;
    *out = v;
    return 0;
}

/* Quoted ts goes through Python's int(str), which accepts ONLY an
 * optionally-signed decimal integer with surrounding whitespace —
 * int("101.9") and int("1e3") raise. Mirror that exactly. */
static int quoted_ts_to_int(const char *s, long n, int64_t *out) {
    long i = 0;
    while (i < n && (s[i] == ' ' || s[i] == '\t')) i++;
    long start = i;
    if (i < n && (s[i] == '+' || s[i] == '-')) i++;
    long digits0 = i;
    int64_t v = 0;
    int neg = (start < n && s[start] == '-');
    while (i < n && s[i] >= '0' && s[i] <= '9') {
        v = v * 10 + (s[i] - '0');
        i++;
    }
    if (i == digits0) return -1;       /* no digits */
    while (i < n && (s[i] == ' ' || s[i] == '\t')) i++;
    if (i != n) return -1;             /* trailing junk e.g. ".9" */
    *out = neg ? -v : v;
    return 0;
}

/* Process one complete line. Counter semantics mirror the Python handler
 * exactly: structural/schema failure -> parse_errors; well-formed record
 * whose id is absent from the table -> unknown_ids (checked BEFORE value
 * conversion, like `_index.get(rec["id"])` runs before np.float32);
 * known id with unconvertible value -> parse_errors. */
static void process_line(Parser *p, const char *s, const char *end,
                         float *latest, int64_t *ts_max, int64_t *counters,
                         char *unk_buf, int64_t *unk_cur, long unk_cap) {
    /* blank lines: Python json.loads("") raises -> parse_error; but a
     * bare "\n" between records is produced by no real producer — treat
     * whitespace-only lines as Python does (error) for parity. */
    const char *c = skip_ws(s, end);
    if (c == end) {
        if (s != end) counters[COUNTER_PARSE_ERRORS]++;  /* "  \n" */
        return;                                          /* "" between \n\n: python
                                                            iterates rfile lines, a
                                                            lone \n IS a line -> error
                                                            handled above via s!=end */
    }
    Fields f;
    if (scan_line(s, end, &f) != 0 || !f.has_id || f.has_id == 3) {
        /* json.loads / rec["id"] / dict.get(unhashable) raised */
        counters[COUNTER_PARSE_ERRORS]++;
        return;
    }
    int32_t idx = -1;
    if (f.has_id == 1)
        idx = table_get(*p->table_ref, f.id, f.id_len);
    if (idx < 0) {
        /* _index.get(...) is None -> unknown BEFORE value conversion: a
         * valueless record with an unknown id counts unknown, not error */
        counters[COUNTER_UNKNOWN_IDS]++;
        /* track_unknown (serve --auto-register): capture the NAME as
         * "id\n" into the caller's bounded buffer; full buffer (or
         * unk_cap 0 = tracking off) = drop (the Python side dedups and
         * re-sees the id next tick). Only string ids (a numeric id can
         * never be registered) and only ids WITHOUT escapes: a captured
         * name must equal what json.loads would produce, and this
         * scanner matches raw bytes — an escaped id ('café') would
         * register under its wire spelling and then dead-letter on the
         * Python fallback path. Python-side strict-UTF-8 decode rejects
         * the invalid-bytes case for the same reason. */
        if (unk_buf != NULL && f.has_id == 1 &&
                memchr(f.id, '\\', (size_t)f.id_len) == NULL &&
                *unk_cur + f.id_len + 1 <= unk_cap) {
            memcpy(unk_buf + *unk_cur, f.id, (size_t)f.id_len);
            unk_buf[*unk_cur + f.id_len] = '\n';
            *unk_cur += f.id_len + 1;
        }
        return;
    }
    double v;
    if (f.has_val && !f.val_quoted && f.val_len == 4
            && memcmp(f.val, "null", 4) == 0) {
        v = NAN;  /* np.float32(None) is nan, not an error */
    } else if (!f.has_val || token_to_double(f.val, f.val_len, &v) != 0) {
        counters[COUNTER_PARSE_ERRORS]++;   /* rec["value"]/np.float32 raised */
        return;
    }
    /* Python assigns latest[i] and THEN converts ts; a bad ts therefore
     * still applies the value (and counts as a parse error). Mirror it. */
    latest[idx] = (float)v;
    if (f.has_ts) {
        int64_t tsv;
        if (f.ts_quoted) {
            if (quoted_ts_to_int(f.ts, f.ts_len, &tsv) != 0) {
                counters[COUNTER_PARSE_ERRORS]++;  /* int("101.9") raised */
                return;
            }
        } else {
            double tv;
            if (token_to_double(f.ts, f.ts_len, &tv) != 0) {
                counters[COUNTER_PARSE_ERRORS]++;  /* int(None) raised */
                return;
            }
            tsv = (int64_t)tv;  /* truncation toward zero, like int(float) */
        }
        if (tsv > *ts_max) *ts_max = tsv;
    }
    counters[COUNTER_PARSED]++;
}

/* Connection EOF: Python's rfile iteration yields a final line even
 * without a trailing newline — process the remainder the same way. */
void rtap_parser_flush(Parser *p, float *latest, int64_t *ts_max,
                       int64_t *counters, char *unk_buf, int64_t *unk_cur,
                       long unk_cap) {
    if (p->rem_overflow) {
        counters[COUNTER_PARSE_ERRORS]++;
        p->rem_overflow = 0;
        p->rem_len = 0;
        return;
    }
    if (p->rem_len > 0) {
        process_line(p, p->rem, p->rem + p->rem_len, latest, ts_max,
                     counters, unk_buf, unk_cur, unk_cap);
        p->rem_len = 0;
    }
}

/* Feed one recv() chunk. Complete lines are processed; a trailing partial
 * line is kept in the parser for the next chunk. Returns 0, or -1 on
 * internal error (never raises mid-stream; malformed data only bumps
 * counters). */
int rtap_parser_feed(Parser *p, const char *buf, long n,
                     float *latest, int64_t *ts_max, int64_t *counters,
                     char *unk_buf, int64_t *unk_cur, long unk_cap) {
    long i = 0;
    while (i < n) {
        const char *nl = (const char *)memchr(buf + i, '\n', (size_t)(n - i));
        if (nl == NULL) {
            long tail = n - i;
            if (p->rem_overflow || p->rem_len + tail > MAX_LINE) {
                p->rem_overflow = 1;   /* swallow until newline */
                p->rem_len = 0;
            } else {
                memcpy(p->rem + p->rem_len, buf + i, (size_t)tail);
                p->rem_len += tail;
            }
            return 0;
        }
        long line_end = nl - buf;
        if (p->rem_overflow) {
            counters[COUNTER_PARSE_ERRORS]++;   /* the oversized line ends here */
            p->rem_overflow = 0;
            p->rem_len = 0;
        } else if (p->rem_len > 0) {
            long tail = line_end - i;
            if (p->rem_len + tail > MAX_LINE) {
                counters[COUNTER_PARSE_ERRORS]++;
                p->rem_len = 0;
            } else {
                memcpy(p->rem + p->rem_len, buf + i, (size_t)tail);
                p->rem_len += tail;
                process_line(p, p->rem, p->rem + p->rem_len, latest, ts_max,
                             counters, unk_buf, unk_cur, unk_cap);
                p->rem_len = 0;
            }
        } else if (line_end > i) {   /* skip empty lines like rfile iteration? no:
                                        a lone "\n" yields the line "\n" in Python,
                                        whose json.loads fails -> parse_error */
            process_line(p, buf + i, buf + line_end, latest, ts_max,
                         counters, unk_buf, unk_cur, unk_cap);
        } else {
            counters[COUNTER_PARSE_ERRORS]++;   /* empty line between \n\n */
        }
        i = line_end + 1;
    }
    return 0;
}
