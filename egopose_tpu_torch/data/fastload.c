/* fastload: threaded chunk reader for packed optical-flow arrays.
 *
 * The reference's dataset reads one .npy per frame on the Python main thread
 * (statereg_dataset.py:151-159) -- a host-I/O hot spot that starves an
 * accelerator.  This native loader serves float32 chunks from large packed
 * per-take files with a pool of POSIX threads doing pread() into
 * caller-provided buffers, so Python overlaps device compute with disk I/O.
 *
 * The PyTorch port's own copy of egopose_tpu/data/fastload.c, bound with
 * ctypes by egopose_tpu_torch/data/fastload.py.
 */
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

#define MAX_FILES 256
#define MAX_THREADS 16

typedef struct {
    int fd;
    int64_t header;      /* byte offset of the data section */
    int64_t frame_bytes; /* bytes per frame */
    int64_t n_frames;
} PackedFile;

typedef struct {
    int file_idx;
    int64_t start;   /* first frame */
    int64_t count;   /* number of frames */
    char *dst;
    int done;        /* 0 = pending, 1 = ok, -1 = error */
} Request;

static PackedFile g_files[MAX_FILES];
static int g_nfiles = 0;

typedef struct {
    Request *reqs;
    int n;
    int next;          /* next request index to claim */
    pthread_mutex_t mu;
} Batch;

int fl_open(const char *path, int64_t header, int64_t frame_bytes,
            int64_t n_frames) {
    if (g_nfiles >= MAX_FILES) return -1;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -2;
    g_files[g_nfiles].fd = fd;
    g_files[g_nfiles].header = header;
    g_files[g_nfiles].frame_bytes = frame_bytes;
    g_files[g_nfiles].n_frames = n_frames;
    return g_nfiles++;
}

static int read_one(Request *r) {
    PackedFile *f = &g_files[r->file_idx];
    int64_t off = f->header + r->start * f->frame_bytes;
    int64_t want = r->count * f->frame_bytes;
    int64_t got = 0;
    while (got < want) {
        ssize_t n = pread(f->fd, r->dst + got, (size_t)(want - got), off + got);
        if (n <= 0) return -1;
        got += n;
    }
    return 1;
}

static void *worker(void *arg) {
    Batch *b = (Batch *)arg;
    for (;;) {
        pthread_mutex_lock(&b->mu);
        int i = b->next < b->n ? b->next++ : -1;
        pthread_mutex_unlock(&b->mu);
        if (i < 0) break;
        b->reqs[i].done = read_one(&b->reqs[i]);
    }
    return NULL;
}

/* Read a batch of frame ranges in parallel.
 * file_idx/starts/counts: arrays of length n; dsts: array of n buffers. */
int fl_read_batch(const int32_t *file_idx, const int64_t *starts,
                  const int64_t *counts, char **dsts, int n, int n_threads) {
    if (n <= 0) return 0;
    Request *reqs = (Request *)malloc(sizeof(Request) * (size_t)n);
    for (int i = 0; i < n; i++) {
        reqs[i].file_idx = file_idx[i];
        reqs[i].start = starts[i];
        reqs[i].count = counts[i];
        reqs[i].dst = dsts[i];
        reqs[i].done = 0;
    }
    Batch b = {reqs, n, 0, PTHREAD_MUTEX_INITIALIZER};
    if (n_threads > MAX_THREADS) n_threads = MAX_THREADS;
    if (n_threads > n) n_threads = n;
    pthread_t tids[MAX_THREADS];
    for (int t = 0; t < n_threads; t++)
        pthread_create(&tids[t], NULL, worker, &b);
    for (int t = 0; t < n_threads; t++)
        pthread_join(tids[t], NULL);
    int ok = 1;
    for (int i = 0; i < n; i++)
        if (reqs[i].done != 1) ok = 0;
    free(reqs);
    return ok ? 0 : -1;
}

void fl_close_all(void) {
    for (int i = 0; i < g_nfiles; i++) close(g_files[i].fd);
    g_nfiles = 0;
}
