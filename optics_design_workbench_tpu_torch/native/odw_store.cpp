// Native results-store writer: asynchronous columnar hit/ray file spooling.
//
// The reference's result persistence pickles per-hit rows on the simulation
// thread (reference: simulation/results_store.py:369-460) and its author
// documents the IO pressure this creates. Here the device produces millions
// of hits per second, so the host IO path is native: the simulation loop
// hands columnar buffers to this library, a background thread writes them
// as raw little-endian `.odwc` files (magic ODWC1) with atomic
// temp-file + rename semantics, and the loop never blocks on disk.
//
// Build: g++ -O2 -shared -fPIC -o libodwstore.so odw_store.cpp -lpthread
// (see utils/native_store.py, which compiles on first use and falls back to
// a pure-python writer when no compiler is available).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Column {
  std::string name;
  char dtype;          // 'f' f32, 'd' f64, 'i' i64, 'b' u8
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;
};

struct Job {
  std::string path;
  std::vector<Column> columns;
};

// All spool state lives in one intentionally LEAKED heap allocation: the
// worker thread is detached and may be blocked in a condition_variable wait
// when the process exits — destroying a static cv/mutex under a waiter is
// undefined behavior and deadlocks glibc's exit handlers. Leaked state is
// never destroyed, so process exit (which tears down all threads) is clean.
struct SpoolState {
  std::mutex mutex;
  std::condition_variable cv;
  std::condition_variable cvDone;
  std::deque<Job> queue;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> pending{0};
  std::atomic<int64_t> errors{0};
  bool workerStarted = false;
};

SpoolState& state() {
  static SpoolState* s = new SpoolState();
  return *s;
}

#define gMutex state().mutex
#define gCv state().cv
#define gCvDone state().cvDone
#define gQueue state().queue
#define gStop state().stop
#define gPending state().pending
#define gErrors state().errors
#define gWorkerStarted state().workerStarted

int writeJob(const Job& job) {
  std::string tmp = job.path + ".tmp-odw";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  int rc = 0;
  const char magic[6] = {'O', 'D', 'W', 'C', '1', '\n'};
  if (fwrite(magic, 1, 6, f) != 6) rc = -2;
  uint32_t ncols = (uint32_t)job.columns.size();
  if (!rc && fwrite(&ncols, 4, 1, f) != 1) rc = -2;
  for (const auto& col : job.columns) {
    if (rc) break;
    uint16_t nameLen = (uint16_t)col.name.size();
    if (fwrite(&nameLen, 2, 1, f) != 1 ||
        fwrite(col.name.data(), 1, nameLen, f) != nameLen ||
        fwrite(&col.dtype, 1, 1, f) != 1) { rc = -2; break; }
    uint8_t ndim = (uint8_t)col.shape.size();
    if (fwrite(&ndim, 1, 1, f) != 1) { rc = -2; break; }
    for (int64_t s : col.shape) {
      uint64_t v = (uint64_t)s;
      if (fwrite(&v, 8, 1, f) != 1) { rc = -2; break; }
    }
    if (!rc && !col.data.empty() &&
        fwrite(col.data.data(), 1, col.data.size(), f) != col.data.size())
      rc = -2;
  }
  if (!rc) {
    fflush(f);
    fsync(fileno(f));
  }
  fclose(f);
  if (!rc && rename(tmp.c_str(), job.path.c_str()) != 0) rc = -3;
  if (rc) unlink(tmp.c_str());
  return rc;
}

void workerLoop() {
  for (;;) {
    Job job;
    {
      std::unique_lock<std::mutex> lock(gMutex);
      gCv.wait(lock, [] { return gStop.load() || !gQueue.empty(); });
      if (gQueue.empty()) {
        if (gStop.load()) return;
        continue;
      }
      job = std::move(gQueue.front());
      gQueue.pop_front();
    }
    if (writeJob(job) != 0) gErrors.fetch_add(1);
    // The pending decrement must be ordered with odw_spool_drain's
    // predicate re-check under gMutex; a bare atomic decrement + notify can
    // slip between drain's predicate evaluation and its block, losing the
    // final wakeup and hanging drain() forever.
    bool last;
    {
      std::lock_guard<std::mutex> lk(gMutex);
      last = gPending.fetch_sub(1) == 1;
    }
    if (last) gCvDone.notify_all();
  }
}

void ensureWorker() {
  std::lock_guard<std::mutex> lock(gMutex);
  if (!gWorkerStarted) {
    gWorkerStarted = true;
    gStop.store(false);
    std::thread(workerLoop).detach();
  }
}

Job buildJob(const char* path, int32_t ncols, const char** names,
             const char* dtypes, const int64_t* ndims,
             const int64_t* shapes, const void** data,
             const int64_t* nbytes) {
  Job job;
  job.path = path;
  job.columns.resize(ncols);
  int64_t shapeOff = 0;
  for (int32_t c = 0; c < ncols; ++c) {
    Column& col = job.columns[c];
    col.name = names[c];
    col.dtype = dtypes[c];
    col.shape.assign(shapes + shapeOff, shapes + shapeOff + ndims[c]);
    shapeOff += ndims[c];
    col.data.resize((size_t)nbytes[c]);
    if (nbytes[c] > 0)
      memcpy(col.data.data(), data[c], (size_t)nbytes[c]);
  }
  return job;
}

}  // namespace

extern "C" {

// synchronous write (blocks until the file is on disk)
int odw_write(const char* path, int32_t ncols, const char** names,
              const char* dtypes, const int64_t* ndims,
              const int64_t* shapes, const void** data,
              const int64_t* nbytes) {
  Job job = buildJob(path, ncols, names, dtypes, ndims, shapes, data, nbytes);
  return writeJob(job);
}

// asynchronous spool: copies the buffers and returns immediately; a
// background thread performs the write
int odw_spool_submit(const char* path, int32_t ncols, const char** names,
                     const char* dtypes, const int64_t* ndims,
                     const int64_t* shapes, const void** data,
                     const int64_t* nbytes) {
  ensureWorker();
  Job job = buildJob(path, ncols, names, dtypes, ndims, shapes, data, nbytes);
  {
    std::lock_guard<std::mutex> lock(gMutex);
    gQueue.push_back(std::move(job));
    gPending.fetch_add(1);
  }
  gCv.notify_one();
  return 0;
}

// wait until every queued spool job has hit the disk; returns the number of
// failed writes since the last call (and resets the error counter)
int64_t odw_spool_drain() {
  std::unique_lock<std::mutex> lock(gMutex);
  gCvDone.wait(lock, [] { return gPending.load() == 0; });
  return gErrors.exchange(0);
}

int64_t odw_spool_pending() { return gPending.load(); }

}  // extern "C"
