// Native scan engine for the grep hot loop (fei_tpu_torch.native).
//
// The agent's dominant tool cost is regex/substring search over every line
// of every candidate file (reference hot loop: fei/tools/code.py:481-488).
// This engine handles the common case — fixed-string needles (identifiers,
// function names) — with memmem over mmap-sized reads and a std::thread
// worker pool; Python keeps full regex semantics as the fallback path.
//
// C ABI: results are streamed back through a caller-supplied callback so no
// allocation contract crosses the boundary. Thread-safe; the callback is
// invoked under a mutex.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread scanner.cpp -o _scanner.so
// (driven by fei_tpu_torch/native/build.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr size_t kBinarySniff = 4096;
constexpr size_t kMaxFileSize = 10u * 1024u * 1024u;  // parity: 10 MB cap

using MatchCallback = void (*)(const char* path, int32_t line_number,
                               const char* line, int32_t line_len);

struct Shared {
  const std::vector<std::string>* paths;
  const char* needle;
  size_t needle_len;
  int32_t max_results;
  MatchCallback cb;
  std::atomic<size_t> next{0};
  std::atomic<int32_t> emitted{0};
  std::mutex cb_mu;
};

void scan_file(const std::string& path, Shared& sh) {
  std::ifstream in(path, std::ios::binary);
  if (!in) return;
  in.seekg(0, std::ios::end);
  const auto size = static_cast<size_t>(in.tellg());
  if (size == 0 || size > kMaxFileSize) return;
  in.seekg(0);
  std::string buf(size, '\0');
  if (!in.read(&buf[0], static_cast<std::streamsize>(size))) return;

  // binary sniff: NUL in the first 4 KiB means skip (parity with Python)
  const size_t sniff = size < kBinarySniff ? size : kBinarySniff;
  if (memchr(buf.data(), '\0', sniff) != nullptr) return;

  const char* data = buf.data();
  const char* end = data + size;
  const char* hit = data;
  // incremental line accounting: count newlines only over the span since
  // the previous match, so a file costs O(size), not O(matches * size)
  const char* counted_to = data;
  int32_t line_no = 1;
  while (sh.emitted.load(std::memory_order_relaxed) < sh.max_results) {
    hit = static_cast<const char*>(
        memmem(hit, static_cast<size_t>(end - hit), sh.needle, sh.needle_len));
    if (hit == nullptr) break;

    // expand to the enclosing line
    const char* line_start = hit;
    while (line_start > data && line_start[-1] != '\n') --line_start;
    const char* line_end =
        static_cast<const char*>(memchr(hit, '\n', static_cast<size_t>(end - hit)));
    if (line_end == nullptr) line_end = end;

    for (const char* p = counted_to; p < line_start; ++p)
      if (*p == '\n') ++line_no;
    counted_to = line_start;

    {
      std::lock_guard<std::mutex> lock(sh.cb_mu);
      if (sh.emitted.load(std::memory_order_relaxed) < sh.max_results) {
        sh.cb(path.c_str(), line_no, line_start,
              static_cast<int32_t>(line_end - line_start));
        sh.emitted.fetch_add(1, std::memory_order_relaxed);
      }
    }
    // continue from the next line: one match per line, like grep -n
    hit = line_end < end ? line_end + 1 : end;
  }
}

void worker(Shared* sh) {
  const size_t n = sh->paths->size();
  while (true) {
    const size_t i = sh->next.fetch_add(1, std::memory_order_relaxed);
    if (i >= n || sh->emitted.load(std::memory_order_relaxed) >= sh->max_results)
      return;
    scan_file((*sh->paths)[i], *sh);
  }
}

}  // namespace

extern "C" {

// paths: '\n'-joined file list. Returns the number of matches emitted, or -1
// on invalid arguments. One callback per matching line (first match wins).
int32_t fei_grep_files(const char* joined_paths, const char* needle,
                       int32_t max_results, int32_t n_threads,
                       MatchCallback cb) {
  if (joined_paths == nullptr || needle == nullptr || cb == nullptr ||
      max_results <= 0)
    return -1;
  const size_t needle_len = strlen(needle);
  if (needle_len == 0) return -1;

  std::vector<std::string> paths;
  const char* p = joined_paths;
  while (*p != '\0') {
    const char* nl = strchr(p, '\n');
    if (nl == nullptr) {
      paths.emplace_back(p);
      break;
    }
    if (nl > p) paths.emplace_back(p, static_cast<size_t>(nl - p));
    p = nl + 1;
  }
  if (paths.empty()) return 0;

  Shared sh;
  sh.paths = &paths;
  sh.needle = needle;
  sh.needle_len = needle_len;
  sh.max_results = max_results;
  sh.cb = cb;

  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 4;
  size_t nt = n_threads > 0 ? static_cast<size_t>(n_threads)
                            : static_cast<size_t>(hw);
  if (nt > paths.size()) nt = paths.size();

  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (size_t i = 0; i < nt; ++i) threads.emplace_back(worker, &sh);
  for (auto& t : threads) t.join();
  return sh.emitted.load();
}

int32_t fei_native_abi_version(void) { return 1; }

}  // extern "C"
