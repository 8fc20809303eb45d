// svt_runtime — native runtime pieces for shapley_vit_tpu_torch.
//
// A copy of the JAX package's csrc/svt_runtime.cpp (host code: inotify,
// preload, file size; no kernel). The port builds its own copy into its own
// build directory and never loads the JAX package's library.
//
// The reference's FL "network" is a shared filesystem: the server polls for
// client checkpoint files with a 1-second sleep loop and a broken O_EXCL
// lock probe (reference shapleyserver/start.py:198-222; SURVEY.md §5). This
// library replaces polling with inotify (IN_MOVED_TO catches the atomic
// rename-into-place protocol of fl/ingestion.py; IN_CLOSE_WRITE catches
// plain writers), and adds a multithreaded file preloader for bulk
// checkpoint/dataset ingestion.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: at first use, by shapley_vit_tpu_torch/ops/_build.build_host
// (g++ -O2 -fPIC -std=c++17 -shared -pthread) into shapley_vit_tpu_torch/build/.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <libgen.h>
#include <poll.h>
#include <sys/inotify.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

bool file_exists(const char* path) {
  struct stat st;
  return ::stat(path, &st) == 0 && S_ISREG(st.st_mode);
}

std::string dirname_of(const std::string& path) {
  std::vector<char> buf(path.begin(), path.end());
  buf.push_back('\0');
  return std::string(::dirname(buf.data()));
}

}  // namespace

extern "C" {

// Wait until every path exists (inotify-driven, poll fallback for races and
// for directories created after the call starts).
//
//   paths      : array of n NUL-terminated absolute paths
//   n          : number of paths
//   timeout_ms : <0 waits forever; otherwise returns after timeout
//   arrived    : out array of n ints (1 = file exists at return)
//
// Returns: number of files present at return (== n on full success),
//          or -1 on setup error (errno left set by the failing call).
int svt_wait_for_files(const char** paths, int n, long timeout_ms,
                       int* arrived) {
  using clock = std::chrono::steady_clock;
  const auto deadline =
      timeout_ms < 0 ? clock::time_point::max()
                     : clock::now() + std::chrono::milliseconds(timeout_ms);

  int fd = ::inotify_init1(IN_NONBLOCK | IN_CLOEXEC);
  if (fd < 0) return -1;

  // Watch each (existing) parent directory once; files land there via
  // rename (IN_MOVED_TO) or direct write (IN_CLOSE_WRITE / IN_CREATE).
  std::unordered_map<int, std::string> wd_to_dir;
  std::unordered_map<std::string, int> dir_to_wd;
  auto ensure_watch = [&](const std::string& dir) {
    if (dir_to_wd.count(dir)) return;
    int wd = ::inotify_add_watch(
        fd, dir.c_str(), IN_MOVED_TO | IN_CLOSE_WRITE | IN_CREATE);
    if (wd >= 0) {
      wd_to_dir[wd] = dir;
      dir_to_wd[dir] = wd;
    }
  };
  for (int i = 0; i < n; ++i) ensure_watch(dirname_of(paths[i]));

  auto scan = [&]() {
    int count = 0;
    for (int i = 0; i < n; ++i) {
      arrived[i] = file_exists(paths[i]) ? 1 : 0;
      count += arrived[i];
    }
    return count;
  };

  int count = scan();
  char buf[4096] __attribute__((aligned(8)));
  while (count < n) {
    auto now = clock::now();
    if (now >= deadline) break;
    long wait_ms = 200;  // re-scan floor: catches dirs created late + races
    if (deadline != clock::time_point::max()) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                      deadline - now)
                      .count();
      if (left < wait_ms) wait_ms = left;
    }
    struct pollfd pfd = {fd, POLLIN, 0};
    int rc = ::poll(&pfd, 1, static_cast<int>(wait_ms));
    if (rc > 0) {
      // drain the event queue; the payload content doesn't matter — any
      // activity triggers a re-scan (simple and race-free)
      while (::read(fd, buf, sizeof(buf)) > 0) {
      }
    }
    // (re)arm watches for parent dirs that appeared after we started
    for (int i = 0; i < n; ++i)
      if (!arrived[i]) ensure_watch(dirname_of(paths[i]));
    count = scan();
  }

  ::close(fd);
  return count;
}

// Wait until every GROUP of candidate paths has at least one member present.
//
// A "group" is one client that may deliver its checkpoint under any of
// several filenames (.pth.tar from reference torch clients, .npz from
// svt-client — fl/ingestion.py:checkpoint_path_candidates). The flat
// ``paths`` array carries all candidates; ``group_of[i]`` maps path i to its
// group id in [0, n_groups).
//
//   paths      : array of n NUL-terminated paths (all groups' candidates)
//   group_of   : n ints — group id per path
//   n          : number of paths
//   n_groups   : number of groups
//   timeout_ms : <0 waits forever; otherwise returns after timeout
//   arrived    : out array of n ints (1 = that path exists at return)
//
// Returns: number of SATISFIED groups (== n_groups on full success), or -1
// on setup error.
int svt_wait_for_file_groups(const char** paths, const int* group_of, int n,
                             int n_groups, long timeout_ms, int* arrived) {
  using clock = std::chrono::steady_clock;
  const auto deadline =
      timeout_ms < 0 ? clock::time_point::max()
                     : clock::now() + std::chrono::milliseconds(timeout_ms);

  int fd = ::inotify_init1(IN_NONBLOCK | IN_CLOEXEC);
  if (fd < 0) return -1;

  std::unordered_map<std::string, int> dir_to_wd;
  auto ensure_watch = [&](const std::string& dir) {
    if (dir_to_wd.count(dir)) return;
    int wd = ::inotify_add_watch(
        fd, dir.c_str(), IN_MOVED_TO | IN_CLOSE_WRITE | IN_CREATE);
    if (wd >= 0) dir_to_wd[dir] = wd;
  };
  for (int i = 0; i < n; ++i) ensure_watch(dirname_of(paths[i]));

  std::vector<char> group_done(n_groups, 0);
  auto scan = [&]() {
    std::fill(group_done.begin(), group_done.end(), 0);
    for (int i = 0; i < n; ++i) {
      arrived[i] = file_exists(paths[i]) ? 1 : 0;
      if (arrived[i] && group_of[i] >= 0 && group_of[i] < n_groups)
        group_done[group_of[i]] = 1;
    }
    int done = 0;
    for (int g = 0; g < n_groups; ++g) done += group_done[g];
    return done;
  };

  int done = scan();
  char buf[4096] __attribute__((aligned(8)));
  while (done < n_groups) {
    auto now = clock::now();
    if (now >= deadline) break;
    long wait_ms = 200;  // re-scan floor: catches dirs created late + races
    if (deadline != clock::time_point::max()) {
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
                      deadline - now)
                      .count();
      if (left < wait_ms) wait_ms = left;
    }
    struct pollfd pfd = {fd, POLLIN, 0};
    int rc = ::poll(&pfd, 1, static_cast<int>(wait_ms));
    if (rc > 0) {
      while (::read(fd, buf, sizeof(buf)) > 0) {
      }
    }
    for (int i = 0; i < n; ++i)
      if (!arrived[i]) ensure_watch(dirname_of(paths[i]));
    done = scan();
  }

  ::close(fd);
  return done;
}

// ---------------------------------------------------------------------------
// parallel file preloader
// ---------------------------------------------------------------------------

// Read n files concurrently into caller-provided buffers.
//
//   paths   : n file paths
//   bufs    : n destination buffers (each of capacity caps[i])
//   caps    : capacity per buffer
//   sizes   : out — bytes read per file (-1 on per-file error)
//   threads : worker count (<=0 selects hardware_concurrency)
//
// Returns number of files fully read.
int svt_preload_files(const char** paths, int n, uint8_t** bufs,
                      const int64_t* caps, int64_t* sizes, int threads) {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 4;
  }
  if (threads > n) threads = n > 0 ? n : 1;

  std::atomic<int> next{0};
  std::atomic<int> ok{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      sizes[i] = -1;
      int fd = ::open(paths[i], O_RDONLY | O_CLOEXEC);
      if (fd < 0) continue;
      // re-stat the OPEN fd: the caller sized bufs[i] from an earlier
      // stat, and under the atomic-rename protocol the file can appear,
      // grow, or be replaced between that stat and this open (TOCTOU) —
      // on any size mismatch the buffer does not describe this file, so
      // report a per-file error and let the caller fall back to a plain
      // read rather than hand it truncated or empty bytes
      struct stat st;
      if (::fstat(fd, &st) != 0 ||
          static_cast<int64_t>(st.st_size) != caps[i]) {
        ::close(fd);
        continue;
      }
      int64_t off = 0;
      bool err = false;
      while (off < caps[i]) {
        ssize_t r = ::pread(fd, bufs[i] + off, caps[i] - off, off);
        if (r < 0 && errno == EINTR) continue;
        if (r <= 0) {  // mid-read error, or the file shrank under us
          err = true;
          break;
        }
        off += r;
      }
      ::close(fd);
      if (err || off != caps[i]) continue;  // partial reads are NOT success
      sizes[i] = off;
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

// File size helper (so Python can allocate exact buffers).
int64_t svt_file_size(const char* path) {
  struct stat st;
  if (::stat(path, &st) != 0) return -1;
  return static_cast<int64_t>(st.st_size);
}

const char* svt_version() { return "svt_runtime 0.1.0"; }

}  // extern "C"
