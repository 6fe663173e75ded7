// ecrhook.cc - native profiler core (the Dr Hook analogue).
//
// Reference parity: drhook/drhook/drhook.c (the IFS profiler's C core):
// per-thread call-stack instrumentation via paired enter/exit calls,
// wall/CPU self- and total-time accounting with parent attribution,
// peak-RSS tracking, and fatal-signal handlers that dump the active
// hook stack (drhook.c signal machinery). This implementation keeps the
// same contract - enter/exit bracketing, near-zero overhead, env-driven
// reporting - with a C ABI for Python ctypes binding.
//
// Build: g++ -O2 -shared -fPIC -o libecrhook.so ecrhook.cc -lpthread

#include <algorithm>
#include <atomic>
#include <chrono>
#include <csignal>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#if defined(__linux__)
#include <execinfo.h>
#include <sys/resource.h>
#include <unistd.h>
#endif

namespace {

using clk = std::chrono::steady_clock;

double now_sec() {
  return std::chrono::duration<double>(clk::now().time_since_epoch())
      .count();
}

double cpu_sec() {
  return static_cast<double>(std::clock()) / CLOCKS_PER_SEC;
}

long peak_rss_kb() {
#if defined(__linux__)
  struct rusage ru;
  if (getrusage(RUSAGE_SELF, &ru) == 0) return ru.ru_maxrss;
#endif
  return 0;
}

struct Stats {
  long calls = 0;
  double total_wall = 0.0;  // inclusive
  double self_wall = 0.0;   // exclusive of children
  double total_cpu = 0.0;
  long max_rss_kb = 0;
};

struct Frame {
  std::string name;
  double t0_wall;
  double t0_cpu;
  double child_wall;  // accumulated inclusive time of children
};

struct ThreadState {
  std::vector<Frame> stack;
  std::unordered_map<std::string, Stats> stats;
};

std::mutex g_registry_mu;
std::vector<ThreadState*> g_registry;

thread_local ThreadState* tls_state = nullptr;

ThreadState& state() {
  if (!tls_state) {
    tls_state = new ThreadState();
    std::lock_guard<std::mutex> lock(g_registry_mu);
    g_registry.push_back(tls_state);
  }
  return *tls_state;
}

std::atomic<bool> g_signals_installed{false};

void signal_handler(int sig) {
  // Dr Hook-style: dump the active hook stack on a fatal signal
  // (drhook.c signal handling), then re-raise with default action.
  fprintf(stderr, "\n[ecrhook] caught signal %d (%s); hook stack:\n", sig,
          strsignal(sig));
  ThreadState* st = tls_state;
  if (st) {
    for (auto it = st->stack.rbegin(); it != st->stack.rend(); ++it) {
      fprintf(stderr, "  at %s\n", it->name.c_str());
    }
  } else {
    fprintf(stderr, "  (no active hooks on this thread)\n");
  }
#if defined(__linux__)
  void* bt[32];
  int n = backtrace(bt, 32);
  backtrace_symbols_fd(bt, n, 2);
#endif
  signal(sig, SIG_DFL);
  raise(sig);
}

}  // namespace

extern "C" {

void ecr_hook_install_signals() {
  bool expected = false;
  if (!g_signals_installed.compare_exchange_strong(expected, true)) return;
  for (int sig : {SIGSEGV, SIGFPE, SIGBUS, SIGILL, SIGABRT}) {
    signal(sig, signal_handler);
  }
}

void ecr_hook_enter(const char* name) {
  ThreadState& st = state();
  st.stack.push_back(Frame{name, now_sec(), cpu_sec(), 0.0});
}

void ecr_hook_exit(const char* name) {
  ThreadState& st = state();
  if (st.stack.empty()) return;
  Frame fr = st.stack.back();
  st.stack.pop_back();
  // tolerate mismatched names by unwinding to the matching frame
  while (fr.name != name && !st.stack.empty()) {
    fr = st.stack.back();
    st.stack.pop_back();
  }
  double wall = now_sec() - fr.t0_wall;
  double cpu = cpu_sec() - fr.t0_cpu;
  Stats& s = st.stats[fr.name];
  s.calls += 1;
  s.total_wall += wall;
  s.self_wall += wall - fr.child_wall;
  s.total_cpu += cpu;
  long rss = peak_rss_kb();
  if (rss > s.max_rss_kb) s.max_rss_kb = rss;
  if (!st.stack.empty()) st.stack.back().child_wall += wall;
}

// Fill parallel arrays with up to `cap` entries, aggregated across all
// threads; returns the number of entries. Names are written into
// `namebuf` (cap * 64 chars, NUL-padded).
int ecr_hook_report(char* namebuf, long* calls, double* total_wall,
                    double* self_wall, double* total_cpu, long* max_rss,
                    int cap) {
  std::unordered_map<std::string, Stats> merged;
  {
    std::lock_guard<std::mutex> lock(g_registry_mu);
    for (ThreadState* st : g_registry) {
      for (const auto& kv : st->stats) {
        Stats& s = merged[kv.first];
        s.calls += kv.second.calls;
        s.total_wall += kv.second.total_wall;
        s.self_wall += kv.second.self_wall;
        s.total_cpu += kv.second.total_cpu;
        if (kv.second.max_rss_kb > s.max_rss_kb)
          s.max_rss_kb = kv.second.max_rss_kb;
      }
    }
  }
  // order by total wall time, descending
  std::vector<std::pair<std::string, Stats>> items(merged.begin(),
                                                   merged.end());
  std::sort(items.begin(), items.end(),
            [](const auto& a, const auto& b) {
              return a.second.total_wall > b.second.total_wall;
            });
  int n = 0;
  for (const auto& kv : items) {
    if (n >= cap) break;
    strncpy(namebuf + n * 64, kv.first.c_str(), 63);
    namebuf[n * 64 + 63] = '\0';
    calls[n] = kv.second.calls;
    total_wall[n] = kv.second.total_wall;
    self_wall[n] = kv.second.self_wall;
    total_cpu[n] = kv.second.total_cpu;
    max_rss[n] = kv.second.max_rss_kb;
    ++n;
  }
  return n;
}

void ecr_hook_reset() {
  std::lock_guard<std::mutex> lock(g_registry_mu);
  for (ThreadState* st : g_registry) st->stats.clear();
}

int ecr_hook_stack_depth() {
  return tls_state ? static_cast<int>(tls_state->stack.size()) : 0;
}

}  // extern "C"
