/* numpy NEP-49 data allocator for sandboxed hosts.
 *
 * On gVisor-class kernels, demand page faults on fresh anonymous memory
 * cost ~1000x a native fault (~130 MB/s effective write bandwidth on first
 * touch), while MAP_POPULATE'd mappings run at memory speed (~4.5 GB/s
 * measured).  glibc cannot be told to populate, so every large numpy
 * buffer (temporaries included!) pays the fault tax on first write.
 *
 * This handler routes allocations >= THRESHOLD to mmap(MAP_POPULATE) with
 * a power-of-two size-class free-list cache (munmap would re-fault the
 * next user), and everything else to plain malloc/calloc.  Installed at
 * `import csparse3_jax` (utils/hostmem.py); harmless (just redundant) on
 * healthy kernels.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_22_API_VERSION
#define NPY_TARGET_VERSION NPY_1_22_API_VERSION
#include <numpy/arrayobject.h>

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#define THRESHOLD (4UL << 20)   /* route >= 4 MB to populated mmap */
#define HDR 64                  /* header keeps 64-byte data alignment */
#define MIN_CLASS 22            /* 4 MB */
#define MAX_CLASS 38            /* 256 GB upper sanity bound */
#define CACHE_PER_CLASS 4
#define MAGIC_MMAP 0x706f706d6d6170ULL
#define MAGIC_HEAP 0x6865617021ULL

typedef struct {
  uint64_t magic;
  uint64_t map_size;   /* total mapping length (mmap) or 0 (heap) */
  uint64_t alloc_size; /* user-requested size */
} hdr_t;

static void* cache_blocks[MAX_CLASS + 1][CACHE_PER_CLASS];
static int cache_count[MAX_CLASS + 1];
static pthread_mutex_t cache_mu = PTHREAD_MUTEX_INITIALIZER;

static int size_class(size_t total) {
  int c = MIN_CLASS;
  while (c <= MAX_CLASS && (1UL << c) < total) c++;
  return c;
}

static void* pop_alloc(size_t size, int zero) {
  if (size >= THRESHOLD) {
    const int c = size_class(size + HDR);
    if (c <= MAX_CLASS) {
      const size_t total = 1UL << c;
      void* p = NULL;
      pthread_mutex_lock(&cache_mu);
      if (cache_count[c] > 0) p = cache_blocks[c][--cache_count[c]];
      pthread_mutex_unlock(&cache_mu);
      int from_cache = (p != NULL);
      if (!p) {
        p = mmap(NULL, total, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_POPULATE, -1, 0);
        if (p == MAP_FAILED) p = NULL;
      }
      if (p) {
        if (zero && from_cache) memset((char*)p + HDR, 0, size);
        hdr_t* h = (hdr_t*)p;
        h->magic = MAGIC_MMAP;
        h->map_size = total;
        h->alloc_size = size;
        return (char*)p + HDR;
      }
    }
    /* fall through to heap on mmap failure / oversize */
  }
  void* p = zero ? calloc(size + HDR, 1) : malloc(size + HDR);
  if (!p) return NULL;
  hdr_t* h = (hdr_t*)p;
  h->magic = MAGIC_HEAP;
  h->map_size = 0;
  h->alloc_size = size;
  return (char*)p + HDR;
}

static void pop_free_base(void* base) {
  hdr_t* h = (hdr_t*)base;
  if (h->magic == MAGIC_MMAP) {
    const int c = size_class(h->map_size); /* exact: map_size is 1<<c */
    int cached = 0;
    pthread_mutex_lock(&cache_mu);
    if (cache_count[c] < CACHE_PER_CLASS) {
      cache_blocks[c][cache_count[c]++] = base;
      cached = 1;
    }
    pthread_mutex_unlock(&cache_mu);
    if (!cached) munmap(base, h->map_size);
  } else {
    free(base);
  }
}

static void* h_malloc(void* ctx, size_t size) {
  (void)ctx;
  return pop_alloc(size, 0);
}

static void* h_calloc(void* ctx, size_t nelem, size_t elsize) {
  (void)ctx;
  if (elsize && nelem > (size_t)-1 / elsize) return NULL;
  return pop_alloc(nelem * elsize, 1);
}

static void* h_realloc(void* ctx, void* ptr, size_t new_size) {
  (void)ctx;
  if (!ptr) return pop_alloc(new_size, 0);
  hdr_t* h = (hdr_t*)((char*)ptr - HDR);
  if (h->magic == MAGIC_MMAP && new_size + HDR <= h->map_size) {
    h->alloc_size = new_size;
    return ptr; /* shrink / fits in the same mapping */
  }
  void* q = pop_alloc(new_size, 0);
  if (!q) return NULL;
  const size_t keep = h->alloc_size < new_size ? h->alloc_size : new_size;
  memcpy(q, ptr, keep);
  pop_free_base(h);
  return q;
}

static void h_free(void* ctx, void* ptr, size_t size) {
  (void)ctx;
  (void)size;
  if (!ptr) return;
  pop_free_base((char*)ptr - HDR);
}

static PyDataMem_Handler handler = {
    "populate_mmap_allocator",
    1,
    {
        NULL,
        h_malloc,
        h_calloc,
        h_realloc,
        h_free,
    },
};

static PyObject* py_install(PyObject* self, PyObject* noargs) {
  (void)self;
  (void)noargs;
  PyObject* cap = PyCapsule_New(&handler, "mem_handler", NULL);
  if (!cap) return NULL;
  PyObject* old = PyDataMem_SetHandler(cap);
  Py_DECREF(cap);
  Py_XDECREF(old);
  Py_RETURN_NONE;
}

static PyObject* py_uninstall(PyObject* self, PyObject* noargs) {
  (void)self;
  (void)noargs;
  PyObject* old = PyDataMem_SetHandler(NULL);
  Py_XDECREF(old);
  Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"install", py_install, METH_NOARGS,
     "Install the MAP_POPULATE numpy data allocator (NEP 49)."},
    {"uninstall", py_uninstall, METH_NOARGS,
     "Restore numpy's default data allocator."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_npalloc",
    "MAP_POPULATE-backed numpy allocator for slow-fault sandboxes.",
    -1, methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__npalloc(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
