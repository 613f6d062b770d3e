/* Native FASTA parser of galah_tpu_torch: the port's own copy of the
 * repository's csrc/ingest.c, with one change: it parses a byte buffer
 * that Python read (and, for gzip input, decompressed with the standard
 * library), so it needs no zlib. One pass over the FASTA bytes
 * produces:
 *
 *   - codes:   uint8 per base, A/C/G/T (case-insensitive) -> 0..3,
 *              anything else -> 255 (ambiguous)
 *   - offsets: int64 contig boundaries, length n_contigs + 1
 *   - num_ambiguous / n50: assembly stats computed in the same pass
 *              (semantics match reference: src/genome_stats.rs:11-51 and
 *              the goldens at :61-87)
 *
 * Line semantics mirror the plain numpy parser in
 * galah_tpu_torch/io/fasta.py (the semantic reference): each line is stripped
 * of leading/trailing ASCII whitespace; blank lines are skipped; a
 * stripped line starting with '>' opens a new contig; sequence bytes
 * before the first header are dropped; interior whitespace inside a
 * sequence line maps through the LUT (i.e. counts as ambiguous).
 *
 * Exposed via ctypes (galah_tpu_torch/io/_cingest.py); no CPython API
 * used, so the call runs with the interpreter lock released.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    uint8_t *codes;
    int64_t total_len;
    int64_t *offsets; /* n_contigs + 1 entries */
    int64_t n_contigs;
    int64_t num_ambiguous;
    int64_t n50;
} GalahGenome;

enum {
    GALAH_OK = 0,
    GALAH_ERR_NO_RECORDS = -2,
    GALAH_ERR_OOM = -3,
};

static const uint8_t CODE_LUT[256] = {
    [0 ... 255] = 255,
    ['A'] = 0, ['C'] = 1, ['G'] = 2, ['T'] = 3,
    ['a'] = 0, ['c'] = 1, ['g'] = 2, ['t'] = 3,
};

/* "whitespace" = bytes Python's bytes.strip() removes */
static inline int is_ws(uint8_t b) {
    return b == ' ' || b == '\t' || b == '\r' || b == '\n' ||
           b == '\v' || b == '\f';
}

typedef struct {
    int64_t *data;
    int64_t len;
    int64_t cap;
} I64Buf;

static int i64_push(I64Buf *b, int64_t v) {
    if (b->len == b->cap) {
        int64_t cap = b->cap ? b->cap * 2 : 64;
        int64_t *p = realloc(b->data, (size_t)cap * sizeof(int64_t));
        if (!p) return -1;
        b->data = p;
        b->cap = cap;
    }
    b->data[b->len++] = v;
    return 0;
}

static int cmp_i64_desc(const void *a, const void *b) {
    int64_t x = *(const int64_t *)a, y = *(const int64_t *)b;
    return (x < y) - (x > y);
}

/* N50: accumulate contig lengths from longest; first length where the
 * cumulative sum reaches half the assembly (matches _compute_n50 /
 * reference golden 8289). Integer-exact: csum >= total/2 <=>
 * 2*csum >= total. */
static int64_t compute_n50(const int64_t *lengths, int64_t n) {
    if (n == 0) return 0;
    int64_t *s = malloc((size_t)n * sizeof(int64_t));
    if (!s) return 0;
    memcpy(s, lengths, (size_t)n * sizeof(int64_t));
    qsort(s, (size_t)n, sizeof(int64_t), cmp_i64_desc);
    int64_t total = 0;
    for (int64_t i = 0; i < n; i++) total += s[i];
    int64_t csum = 0, n50 = s[n - 1];
    for (int64_t i = 0; i < n; i++) {
        csum += s[i];
        if (2 * csum >= total) { n50 = s[i]; break; }
    }
    free(s);
    return n50;
}

void galah_free_genome(GalahGenome *g) {
    if (!g) return;
    free(g->codes);
    free(g->offsets);
    g->codes = NULL;
    g->offsets = NULL;
}

/* Parse `size` FASTA bytes at `data` (not modified, not freed). */
int galah_parse_fasta(const uint8_t *data, int64_t size, GalahGenome *out) {
    memset(out, 0, sizeof(*out));
    int rc = GALAH_OK;

    /* codes can never exceed the raw byte count */
    uint8_t *codes = malloc(size ? (size_t)size : 1);
    if (!codes) return GALAH_ERR_OOM;
    int64_t clen = 0;
    I64Buf lens = {0};
    int64_t contig_start = 0;
    int64_t ambiguous = 0;
    int in_record = 0;

    const uint8_t *p = data, *end = data + size;
    while (p < end) {
        const uint8_t *nl = memchr(p, '\n', (size_t)(end - p));
        const uint8_t *eol = nl ? nl : end;
        const uint8_t *s = p, *e = eol;
        while (s < e && is_ws(*s)) s++;
        while (e > s && is_ws(e[-1])) e--;
        if (s < e) {
            if (*s == '>') {
                if (in_record) {
                    if (i64_push(&lens, clen - contig_start) != 0) {
                        rc = GALAH_ERR_OOM; goto done;
                    }
                }
                in_record = 1;
                contig_start = clen;
            } else if (in_record) {
                for (const uint8_t *q = s; q < e; q++) {
                    uint8_t c = CODE_LUT[*q];
                    codes[clen++] = c;
                    ambiguous += (c == 255);
                }
            }
        }
        p = eol + 1;
    }
    if (!in_record) { rc = GALAH_ERR_NO_RECORDS; goto done; }
    if (i64_push(&lens, clen - contig_start) != 0) {
        rc = GALAH_ERR_OOM; goto done;
    }

    out->offsets = malloc((size_t)(lens.len + 1) * sizeof(int64_t));
    if (!out->offsets) { rc = GALAH_ERR_OOM; goto done; }
    out->offsets[0] = 0;
    for (int64_t i = 0; i < lens.len; i++)
        out->offsets[i + 1] = out->offsets[i] + lens.data[i];
    out->n_contigs = lens.len;
    out->codes = codes;
    out->total_len = clen;
    codes = NULL; /* ownership moved to out */
    out->num_ambiguous = ambiguous;
    out->n50 = compute_n50(lens.data, lens.len);

done:
    free(codes);
    free(lens.data);
    if (rc != GALAH_OK) galah_free_genome(out);
    return rc;
}
