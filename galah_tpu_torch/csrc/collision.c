/* Native collision counting over sketch/marker matrices.
 *
 * A copy of the repository's csrc/collision.c for the port: the C twin
 * of galah_tpu_torch/ops/collision.py::collision_pair_counts — the
 * inverted-index screen that replaces every O(N^2) all-pairs pass
 * (reference analog: skani's marker screening, src/skani.rs:54-70).
 * The numpy formulation is O(NK log NK) but churns multi-GB
 * temporaries through argsort/fancy-indexing/np.unique compaction; at
 * N=100k (1e8 hashes) it measured 249 s on one core. This version:
 *
 *   1. extracts (hash, row) for every valid entry,
 *   2. LSB radix sort, 4 passes x 16 bits, payload carried alongside,
 *   3. walks runs of equal hashes:
 *        - small runs (2..big_run): emit every i<j pair, weight 1,
 *          into an open-addressing hashmap keyed i*n+j;
 *        - big runs (> big_run, near-duplicate mega-clusters): the
 *          run's sorted distinct rows form a group; identical groups
 *          across hashes are deduplicated by content and their
 *          occurrence counts added once per pair (keeps work
 *          O(K*m + output) instead of O(K*m^2)) — exactly the numpy
 *          path's group-signature semantics;
 *   4. returns the distinct (i, j, count) triples (unsorted; the
 *      Python wrapper orders them to match numpy's unique-sorted
 *      output bit-for-bit).
 *
 * Single-threaded by design: the pass is memory-bandwidth-bound and
 * the deployment box is one core; the radix buffers are the only
 * large allocations (~24 bytes per hash).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- open-addressing hashmap: u64 key -> i64 count ---- */

typedef struct {
    uint64_t *keys;
    int64_t *vals;
    uint8_t *used;
    uint64_t mask; /* capacity - 1 */
    int64_t n;     /* occupied slots */
} Map;

static uint64_t mix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

static int map_init(Map *m, uint64_t cap_pow2) {
    m->keys = (uint64_t *)malloc(cap_pow2 * sizeof(uint64_t));
    m->vals = (int64_t *)malloc(cap_pow2 * sizeof(int64_t));
    m->used = (uint8_t *)calloc(cap_pow2, 1);
    m->mask = cap_pow2 - 1;
    m->n = 0;
    if (!m->keys || !m->vals || !m->used) return -1;
    return 0;
}

static void map_free(Map *m) {
    free(m->keys);
    free(m->vals);
    free(m->used);
}

static int map_grow(Map *m);

/* Lookup without insert: returns the value or -1. */
static int64_t map_get(const Map *m, uint64_t key) {
    uint64_t h = mix64(key) & m->mask;
    while (m->used[h]) {
        if (m->keys[h] == key) return m->vals[h];
        h = (h + 1) & m->mask;
    }
    return -1;
}

/* Insert or overwrite. */
static int map_put(Map *m, uint64_t key, int64_t val) {
    if ((uint64_t)m->n * 2 >= m->mask + 1) {
        if (map_grow(m)) return -1;
    }
    uint64_t h = mix64(key) & m->mask;
    while (m->used[h]) {
        if (m->keys[h] == key) {
            m->vals[h] = val;
            return 0;
        }
        h = (h + 1) & m->mask;
    }
    m->used[h] = 1;
    m->keys[h] = key;
    m->vals[h] = val;
    m->n++;
    return 0;
}

static int map_add(Map *m, uint64_t key, int64_t w) {
    if ((uint64_t)m->n * 2 >= m->mask + 1) {
        if (map_grow(m)) return -1;
    }
    uint64_t h = mix64(key) & m->mask;
    while (m->used[h]) {
        if (m->keys[h] == key) {
            m->vals[h] += w;
            return 0;
        }
        h = (h + 1) & m->mask;
    }
    m->used[h] = 1;
    m->keys[h] = key;
    m->vals[h] = w;
    m->n++;
    return 0;
}

static int map_grow(Map *m) {
    Map bigger;
    if (map_init(&bigger, (m->mask + 1) * 2)) {
        map_free(&bigger); /* free any partial allocations */
        return -1;
    }
    for (uint64_t s = 0; s <= m->mask; s++) {
        if (!m->used[s]) continue;
        uint64_t h = mix64(m->keys[s]) & bigger.mask;
        while (bigger.used[h]) h = (h + 1) & bigger.mask;
        bigger.used[h] = 1;
        bigger.keys[h] = m->keys[s];
        bigger.vals[h] = m->vals[s];
        bigger.n++;
    }
    map_free(m);
    *m = bigger;
    return 0;
}

/* ---- big-run group table: content-addressed sorted row lists ---- */

typedef struct {
    int64_t *rows;   /* concatenated group row lists */
    int64_t *starts; /* group g occupies rows[starts[g]..starts[g+1]) */
    int64_t *occ;    /* occurrence count per group */
    int64_t *next;   /* same-signature chain link per group, -1 ends */
    Map sigmap;      /* content hash -> chain head group index */
    int64_t n_groups, rows_len, rows_cap, groups_cap;
} Groups;

static int groups_init(Groups *g) {
    memset(g, 0, sizeof(*g));
    g->rows_cap = 1 << 16;
    g->groups_cap = 1 << 10;
    g->rows = (int64_t *)malloc(g->rows_cap * sizeof(int64_t));
    g->starts = (int64_t *)malloc((g->groups_cap + 1) * sizeof(int64_t));
    g->occ = (int64_t *)malloc(g->groups_cap * sizeof(int64_t));
    g->next = (int64_t *)malloc(g->groups_cap * sizeof(int64_t));
    if (map_init(&g->sigmap, 1 << 10)) return -1;
    if (!g->rows || !g->starts || !g->occ || !g->next) return -1;
    g->starts[0] = 0;
    return 0;
}

static void groups_free(Groups *g) {
    free(g->rows);
    free(g->starts);
    free(g->occ);
    free(g->next);
    map_free(&g->sigmap);
}

static uint64_t group_hash(const int64_t *rows, int64_t m) {
    uint64_t h = 1469598103934665603ULL ^ (uint64_t)m;
    for (int64_t i = 0; i < m; i++)
        h = mix64(h ^ (uint64_t)rows[i]);
    return h;
}

/* Add one occurrence of the sorted, distinct row list `rows[0..m)`.
 * O(1) expected via the signature hashmap; exact regardless of 64-bit
 * signature collisions (chained content memcmp). */
static int groups_add(Groups *g, const int64_t *rows, int64_t m) {
    uint64_t sig = group_hash(rows, m);
    int64_t head = map_get(&g->sigmap, sig);
    for (int64_t k = head; k >= 0; k = g->next[k]) {
        int64_t len = g->starts[k + 1] - g->starts[k];
        if (len == m &&
            !memcmp(g->rows + g->starts[k], rows,
                    (size_t)m * sizeof(int64_t))) {
            g->occ[k]++;
            return 0;
        }
    }
    if (g->n_groups == g->groups_cap) {
        /* grow one array at a time, committing each success so a
         * mid-sequence failure leaves every pointer valid for free */
        int64_t new_cap = g->groups_cap * 2;
        int64_t *ns = (int64_t *)realloc(
            g->starts, (new_cap + 1) * sizeof(int64_t));
        if (!ns) return -1;
        g->starts = ns;
        int64_t *no = (int64_t *)realloc(
            g->occ, new_cap * sizeof(int64_t));
        if (!no) return -1;
        g->occ = no;
        int64_t *nn = (int64_t *)realloc(
            g->next, new_cap * sizeof(int64_t));
        if (!nn) return -1;
        g->next = nn;
        g->groups_cap = new_cap;
    }
    while (g->rows_len + m > g->rows_cap) {
        int64_t new_cap = g->rows_cap * 2;
        int64_t *nr = (int64_t *)realloc(
            g->rows, new_cap * sizeof(int64_t));
        if (!nr) return -1;
        g->rows = nr;
        g->rows_cap = new_cap;
    }
    memcpy(g->rows + g->rows_len, rows, (size_t)m * sizeof(int64_t));
    g->rows_len += m;
    g->occ[g->n_groups] = 1;
    g->next[g->n_groups] = head;
    if (map_put(&g->sigmap, sig, g->n_groups)) return -1;
    g->n_groups++;
    g->starts[g->n_groups] = g->rows_len;
    return 0;
}

/* ---- insertion sort for small run row-id lists ---- */

static void isort64(int64_t *a, int64_t m) {
    for (int64_t i = 1; i < m; i++) {
        int64_t v = a[i], j = i - 1;
        while (j >= 0 && a[j] > v) {
            a[j + 1] = a[j];
            j--;
        }
        a[j + 1] = v;
    }
}

/* Sort + dedupe in place; returns new length. */
static int64_t sort_unique(int64_t *a, int64_t m) {
    isort64(a, m);
    int64_t w = 0;
    for (int64_t i = 0; i < m; i++)
        if (i == 0 || a[i] != a[i - 1]) a[w++] = a[i];
    return w;
}

/* ---- main entry ----
 *
 * mat: (n, width) uint64, rows sorted ascending, SENTINEL-padded;
 * lens: per-row valid count. Emits distinct colliding pairs with
 * exact |A intersect B| counts. Returns the number of distinct pairs
 * (may exceed cap — only the first cap are written), or -1 on
 * allocation failure.
 */
int64_t galah_collision_pair_counts(
    const uint64_t *mat, int64_t n, int64_t width, const int64_t *lens,
    int64_t big_run,
    int64_t *out_i, int64_t *out_j, int64_t *out_c, int64_t cap) {
    int64_t total = 0;
    for (int64_t r = 0; r < n; r++) total += lens[r];
    if (total == 0) return 0;

    uint64_t *k0 = (uint64_t *)malloc(total * sizeof(uint64_t));
    uint64_t *k1 = (uint64_t *)malloc(total * sizeof(uint64_t));
    int64_t *p0 = (int64_t *)malloc(total * sizeof(int64_t));
    int64_t *p1 = (int64_t *)malloc(total * sizeof(int64_t));
    if (!k0 || !k1 || !p0 || !p1) {
        free(k0);
        free(k1);
        free(p0);
        free(p1);
        return -1;
    }
    int64_t m = 0;
    for (int64_t r = 0; r < n; r++) {
        const uint64_t *row = mat + r * width;
        for (int64_t c = 0; c < lens[r]; c++) {
            k0[m] = row[c];
            p0[m] = r;
            m++;
        }
    }

    /* LSB radix sort, 4 passes x 16 bits. The 512 KiB histogram is
     * heap-allocated: this pass can run on worker threads, whose
     * stacks may be far smaller than the main thread's (e.g. musl's
     * 128 KiB default). */
    static const int RADIX_BITS = 16;
    int64_t *hist = (int64_t *)malloc((1 << 16) * sizeof(int64_t));
    if (!hist) {
        free(k0);
        free(k1);
        free(p0);
        free(p1);
        return -1;
    }
    for (int pass = 0; pass < 4; pass++) {
        int shift = pass * RADIX_BITS;
        memset(hist, 0, (1 << 16) * sizeof(int64_t));
        for (int64_t i = 0; i < m; i++)
            hist[(k0[i] >> shift) & 0xFFFF]++;
        int64_t acc = 0;
        for (int64_t b = 0; b < (1 << 16); b++) {
            int64_t c = hist[b];
            hist[b] = acc;
            acc += c;
        }
        for (int64_t i = 0; i < m; i++) {
            int64_t d = hist[(k0[i] >> shift) & 0xFFFF]++;
            k1[d] = k0[i];
            p1[d] = p0[i];
        }
        uint64_t *tk = k0;
        k0 = k1;
        k1 = tk;
        int64_t *tp = p0;
        p0 = p1;
        p1 = tp;
    }
    free(hist);
    free(k1);
    free(p1);

    /* zero-init so the cleanup frees are safe even when an init
     * fails partway (free(NULL) is a no-op) */
    Map map;
    Groups groups;
    memset(&map, 0, sizeof(map));
    memset(&groups, 0, sizeof(groups));
    int err = map_init(&map, 1 << 16);
    if (!err) err = groups_init(&groups);
    int64_t *scratch = NULL;
    int64_t scratch_cap = 0;

    for (int64_t s = 0; s < m && !err;) {
        int64_t e = s + 1;
        while (e < m && k0[e] == k0[s]) e++;
        int64_t run = e - s;
        if (run >= 2) {
            if (run > scratch_cap) {
                scratch_cap = run * 2;
                int64_t *ns = (int64_t *)realloc(
                    scratch, scratch_cap * sizeof(int64_t));
                if (!ns) {
                    err = 1;
                    break;
                }
                scratch = ns;
            }
            memcpy(scratch, p0 + s, (size_t)run * sizeof(int64_t));
            if (run > big_run) {
                /* numpy big-run path dedupes rows (np.unique) */
                int64_t u = sort_unique(scratch, run);
                err = groups_add(&groups, scratch, u);
            } else {
                /* numpy small-run path sorts WITHOUT dedupe and only
                 * skips i==j — keep that exact semantics (duplicate
                 * row ids cannot occur for distinct-valued rows, but
                 * the defensive behavior must match bit-for-bit) */
                isort64(scratch, run);
                for (int64_t a = 0; a < run && !err; a++)
                    for (int64_t b = a + 1; b < run; b++) {
                        if (scratch[a] == scratch[b]) continue;
                        err = map_add(&map,
                                      (uint64_t)scratch[a] * (uint64_t)n +
                                          (uint64_t)scratch[b],
                                      1);
                    }
            }
        }
        s = e;
    }
    for (int64_t g = 0; g < groups.n_groups && !err; g++) {
        const int64_t *rows = groups.rows + groups.starts[g];
        int64_t len = groups.starts[g + 1] - groups.starts[g];
        int64_t occ = groups.occ[g];
        for (int64_t a = 0; a < len && !err; a++)
            for (int64_t b = a + 1; b < len; b++)
                err = map_add(&map,
                              (uint64_t)rows[a] * (uint64_t)n +
                                  (uint64_t)rows[b],
                              occ);
    }

    int64_t found = -1;
    if (!err) {
        found = map.n;
        int64_t w = 0;
        for (uint64_t slot = 0; slot <= map.mask && w < cap; slot++) {
            if (!map.used[slot]) continue;
            out_i[w] = (int64_t)(map.keys[slot] / (uint64_t)n);
            out_j[w] = (int64_t)(map.keys[slot] % (uint64_t)n);
            out_c[w] = map.vals[slot];
            w++;
        }
    }
    free(scratch);
    free(k0);
    free(p0);
    map_free(&map);
    groups_free(&groups);
    return found;
}
