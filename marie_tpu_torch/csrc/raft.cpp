// marie-raft — RAFT consensus core for replicated stateful executors
// (the port's copy of the JAX package's native RAFT core; both build from
// the same code, so a mixed cluster speaks one wire).
//
// A hashicorp/raft-style node whose FSM forwards committed entries to the
// local executor, exposed through a C ABI consumed from Python via ctypes
// (marie_tpu_torch/serve/consensus/):
//   raft_create / raft_start / raft_add_voter / raft_submit /
//   raft_get_configuration / raft_state / raft_leader / raft_shutdown
//
// Implementation: standard RAFT (Ongaro & Ousterhout) — randomized
// election timeouts, term-checked RequestVote / AppendEntries, log
// replication with commit on majority match, FSM apply callback on
// commit.  Transport is length-prefixed JSON over TCP (no external
// dependencies).
//
// Log compaction (hashicorp/raft snapshots AND truncates: fsm.go
// Snapshot + snapshot.go): raft_snapshot(blob) records the
// executor-state blob (produced by the Python layer's snapshot RPC),
// pins (snapshot_index, snapshot_term) at last_applied, and DROPS the
// log prefix.  A follower whose next_index falls below snapshot_index
// receives an install_snapshot RPC — the blob is handed to the restore
// callback and replication resumes from the snapshot tail, so a fresh
// follower never replays from entry 0.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <functional>
#include <map>
#include <mutex>
#include <random>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

using namespace std::chrono;

// ----------------------------------------------------------------- util
namespace mj {  // minimal JSON (flat string/int maps + entry arrays)

static std::string esc(const std::string& s) {
  std::string o;
  for (char c : s) {
    if (c == '"' || c == '\\') { o += '\\'; o += c; }
    else if (c == '\n') o += "\\n";
    else o += c;
  }
  return o;
}

struct Value {
  std::map<std::string, std::string> str;
  std::map<std::string, long long> num;
  std::vector<std::map<std::string, std::string>> entries;  // "entries" key
};

// parser for the subset we emit (flat object, optional entries array of
// flat string objects)
struct Parser {
  const std::string& s;
  size_t i = 0;
  explicit Parser(const std::string& in) : s(in) {}
  void ws() { while (i < s.size() && isspace((unsigned char)s[i])) i++; }
  bool eat(char c) { ws(); if (i < s.size() && s[i] == c) { i++; return true; } return false; }
  std::string parse_string() {
    ws(); if (i >= s.size() || s[i] != '"') return "";
    i++; std::string o;
    while (i < s.size() && s[i] != '"') {
      if (s[i] == '\\' && i + 1 < s.size()) {
        i++;
        if (s[i] == 'n') o += '\n'; else o += s[i];
      } else o += s[i];
      i++;
    }
    i++; return o;
  }
  long long parse_num() {
    ws(); size_t j = i; if (i < s.size() && (s[i] == '-')) i++;
    while (i < s.size() && isdigit((unsigned char)s[i])) i++;
    return atoll(s.substr(j, i - j).c_str());
  }
  std::map<std::string, std::string> parse_flat() {
    std::map<std::string, std::string> o;
    if (!eat('{')) return o;
    while (true) {
      ws(); if (eat('}')) break;
      std::string k = parse_string(); eat(':');
      ws();
      if (i < s.size() && s[i] == '"') o[k] = parse_string();
      else { size_t j = i; parse_num(); o[k] = s.substr(j, i - j); }
      eat(',');
    }
    return o;
  }
  Value parse() {
    Value v;
    if (!eat('{')) return v;
    while (true) {
      ws(); if (eat('}')) break;
      std::string k = parse_string(); eat(':'); ws();
      if (k == "entries") {
        eat('[');
        while (true) {
          ws(); if (eat(']')) break;
          v.entries.push_back(parse_flat());
          eat(',');
        }
      } else if (i < s.size() && s[i] == '"') {
        v.str[k] = parse_string();
      } else {
        v.num[k] = parse_num();
      }
      eat(',');
    }
    return v;
  }
};

}  // namespace mj

// ----------------------------------------------------------------- raft
typedef void (*apply_cb_t)(const char* data, int len, long long index, void* user);

struct LogEntry {
  long long term;
  std::string data;
};

struct Peer {
  std::string id;
  std::string addr;  // host:port
  long long next_index = 1;
  long long match_index = 0;
};

enum class Role { Follower, Candidate, Leader };

struct RaftNode {
  std::string id;
  std::string bind_host;
  int bind_port;
  apply_cb_t apply_cb;
  void* user;

  std::mutex mu;
  Role role = Role::Follower;
  long long current_term = 0;
  std::string voted_for;
  std::string leader_id;
  // log[0] holds index snapshot_index+1 (1-indexed externally); the
  // prefix up to snapshot_index lives only in snapshot_data
  std::vector<LogEntry> log;
  long long snapshot_index = 0;
  long long snapshot_term = 0;
  std::string snapshot_data;  // opaque executor-state blob
  apply_cb_t restore_cb = nullptr;
  void* restore_user = nullptr;
  // restore handed off to apply_loop so the Python callback never runs
  // under the node mutex
  long long pending_restore_index = -1;
  std::string pending_restore_data;
  long long commit_index = 0;
  long long last_applied = 0;
  std::vector<Peer> peers;  // excludes self

  std::atomic<bool> running{false};
  steady_clock::time_point last_heartbeat = steady_clock::now();
  int election_timeout_ms = 300;
  std::thread tick_thread;
  std::thread accept_thread;
  std::thread apply_thread;
  std::condition_variable apply_cv;
  int listen_fd = -1;
  std::mt19937 rng{std::random_device{}()};

  void reset_election_timeout() {
    std::uniform_int_distribution<int> d(250, 500);
    election_timeout_ms = d(rng);
    last_heartbeat = steady_clock::now();
  }

  long long last_log_index() { return snapshot_index + (long long)log.size(); }
  long long last_log_term() {
    return log.empty() ? snapshot_term : log.back().term;
  }
  // term of entry idx; valid for snapshot_index <= idx <= last_log_index
  long long term_at(long long idx) {
    if (idx == snapshot_index) return snapshot_term;
    if (idx < snapshot_index || idx > last_log_index()) return -1;
    return log[(size_t)(idx - snapshot_index - 1)].term;
  }
  LogEntry& entry_at(long long idx) {
    return log[(size_t)(idx - snapshot_index - 1)];
  }
};

// --- framed JSON over TCP ------------------------------------------------
static bool send_all(int fd, const char* buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t w = ::send(fd, buf + off, n - off, MSG_NOSIGNAL);
    if (w <= 0) return false;
    off += (size_t)w;
  }
  return true;
}

static bool send_msg(int fd, const std::string& payload) {
  uint32_t len = htonl((uint32_t)payload.size());
  if (!send_all(fd, (const char*)&len, 4)) return false;
  return send_all(fd, payload.data(), payload.size());
}

static bool recv_all(int fd, char* buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t r = ::recv(fd, buf + off, n - off, 0);
    if (r <= 0) return false;
    off += (size_t)r;
  }
  return true;
}

static bool recv_msg(int fd, std::string& out) {
  uint32_t len_n;
  if (!recv_all(fd, (char*)&len_n, 4)) return false;
  uint32_t len = ntohl(len_n);
  if (len > 64u * 1024u * 1024u) return false;
  out.resize(len);
  return recv_all(fd, out.data(), len);
}

static int dial(const std::string& addr, int timeout_ms = 300) {
  auto colon = addr.rfind(':');
  if (colon == std::string::npos) return -1;
  std::string host = addr.substr(0, colon);
  int port = atoi(addr.substr(colon + 1).c_str());
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  struct timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, host == "localhost" ? "127.0.0.1" : host.c_str(), &sa.sin_addr);
  if (::connect(fd, (sockaddr*)&sa, sizeof(sa)) != 0) { ::close(fd); return -1; }
  return fd;
}

// base64 for log payloads (binary-safe inside JSON)
static const char* B64 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
static std::string b64enc(const std::string& in) {
  std::string out;
  int val = 0, valb = -6;
  for (unsigned char c : in) {
    val = (val << 8) + c; valb += 8;
    while (valb >= 0) { out.push_back(B64[(val >> valb) & 0x3F]); valb -= 6; }
  }
  if (valb > -6) out.push_back(B64[((val << 8) >> (valb + 8)) & 0x3F]);
  while (out.size() % 4) out.push_back('=');
  return out;
}
static std::string b64dec(const std::string& in) {
  std::vector<int> T(256, -1);
  for (int i = 0; i < 64; i++) T[(unsigned char)B64[i]] = i;
  std::string out; int val = 0, valb = -8;
  for (unsigned char c : in) {
    if (T[c] == -1) break;
    val = (val << 6) + T[c]; valb += 6;
    if (valb >= 0) { out.push_back(char((val >> valb) & 0xFF)); valb -= 8; }
  }
  return out;
}

// --- RPC construction ----------------------------------------------------
static std::string rpc_round_trip(const std::string& addr, const std::string& req) {
  int fd = dial(addr);
  if (fd < 0) return "";
  std::string resp;
  if (!send_msg(fd, req) || !recv_msg(fd, resp)) { ::close(fd); return ""; }
  ::close(fd);
  return resp;
}

static void become_follower(RaftNode* n, long long term) {
  n->role = Role::Follower;
  n->current_term = term;
  n->voted_for.clear();
}

// handle one incoming RPC (node mutex held by caller)
static std::string handle_rpc(RaftNode* n, const std::string& raw) {
  mj::Parser p(raw);
  mj::Value m = p.parse();
  std::string type = m.str.count("type") ? m.str["type"] : "";
  std::ostringstream out;

  std::lock_guard<std::mutex> lk(n->mu);
  if (type == "request_vote") {
    long long term = m.num["term"];
    std::string cand = m.str["candidate"];
    long long llt = m.num["last_log_term"], lli = m.num["last_log_index"];
    if (term > n->current_term) become_follower(n, term);
    bool up_to_date = (llt > n->last_log_term()) ||
                      (llt == n->last_log_term() && lli >= n->last_log_index());
    bool grant = term >= n->current_term &&
                 (n->voted_for.empty() || n->voted_for == cand) && up_to_date;
    if (grant) {
      n->voted_for = cand;
      n->last_heartbeat = steady_clock::now();
    }
    out << "{\"type\":\"vote_reply\",\"term\":" << n->current_term
        << ",\"granted\":" << (grant ? 1 : 0) << "}";
  } else if (type == "append_entries") {
    long long term = m.num["term"];
    bool ok = false;
    if (term >= n->current_term) {
      if (term > n->current_term || n->role != Role::Follower)
        become_follower(n, term);
      n->leader_id = m.str["leader"];
      n->last_heartbeat = steady_clock::now();
      long long prev_idx = m.num["prev_log_index"];
      long long prev_term = m.num["prev_log_term"];
      // entries at or below snapshot_index are covered by the snapshot
      // (they were committed before it was taken) — treat as matching
      bool prev_ok = prev_idx <= n->snapshot_index ||
                     (prev_idx <= n->last_log_index() &&
                      n->term_at(prev_idx) == prev_term);
      if (prev_ok) {
        ok = true;
        long long idx = prev_idx;
        for (auto& e : m.entries) {
          idx++;
          if (idx <= n->snapshot_index) continue;  // already snapshotted
          long long eterm = atoll(e["term"].c_str());
          if (idx <= n->last_log_index()) {
            if (n->term_at(idx) != eterm) {
              // conflict: truncate from idx (log[0] == snapshot_index+1)
              n->log.resize((size_t)(idx - n->snapshot_index - 1));
              n->log.push_back({eterm, b64dec(e["data"])});
            }
          } else {
            n->log.push_back({eterm, b64dec(e["data"])});
          }
        }
        long long leader_commit = m.num["leader_commit"];
        if (leader_commit > n->commit_index) {
          n->commit_index = std::min(leader_commit, n->last_log_index());
          n->apply_cv.notify_all();
        }
      }
    }
    out << "{\"type\":\"append_reply\",\"term\":" << n->current_term
        << ",\"success\":" << (ok ? 1 : 0)
        << ",\"match_index\":" << n->last_log_index() << "}";
  } else if (type == "install_snapshot") {
    // leader -> lagging follower: executor-state blob + (index, term);
    // replaces the log prefix so the follower catches up without
    // replaying from entry 0 (hashicorp InstallSnapshot semantics)
    long long term = m.num["term"];
    bool ok = false;
    if (term >= n->current_term) {
      if (term > n->current_term || n->role != Role::Follower)
        become_follower(n, term);
      n->leader_id = m.str["leader"];
      n->last_heartbeat = steady_clock::now();
      long long sidx = m.num["snapshot_index"];
      long long sterm = m.num["snapshot_term"];
      if (sidx > n->snapshot_index) {
        std::string data = b64dec(m.str["data"]);
        if (sidx <= n->last_log_index() && n->term_at(sidx) == sterm) {
          // matching tail survives — drop only the covered prefix
          n->log.erase(n->log.begin(),
                       n->log.begin() + (size_t)(sidx - n->snapshot_index));
        } else {
          n->log.clear();
        }
        n->snapshot_index = sidx;
        n->snapshot_term = sterm;
        n->snapshot_data = data;
        if (n->commit_index < sidx) n->commit_index = sidx;
        if (n->last_applied < sidx) {
          n->last_applied = sidx;
          // restore runs in apply_loop, outside the node mutex
          n->pending_restore_index = sidx;
          n->pending_restore_data = std::move(data);
        }
        n->apply_cv.notify_all();
      }
      ok = true;
    }
    out << "{\"type\":\"install_snapshot_reply\",\"term\":" << n->current_term
        << ",\"ok\":" << (ok ? 1 : 0) << "}";
  } else if (type == "add_voter") {
    // leader-side membership change (simplified joint consensus: single
    // server addition applied immediately, as hashicorp AddVoter does for
    // small clusters)
    std::string id = m.str["id"], addr = m.str["addr"];
    bool exists = false;
    for (auto& pr : n->peers) {
      if (pr.id == id) { pr.addr = addr; exists = true; }
    }
    if (!exists && id != n->id) {
      Peer pr; pr.id = id; pr.addr = addr;
      pr.next_index = n->last_log_index() + 1;
      n->peers.push_back(pr);
    }
    out << "{\"type\":\"add_voter_reply\",\"ok\":1}";
  } else if (type == "submit") {
    // forwarded client write (leader only: a follower
    // answers "not the leader" and the client retries, networking/__init__.py:399)
    if (n->role != Role::Leader) {
      out << "{\"type\":\"submit_reply\",\"ok\":0,\"leader\":\""
          << mj::esc(n->leader_id) << "\"}";
    } else {
      n->log.push_back({n->current_term, b64dec(m.str["data"])});
      out << "{\"type\":\"submit_reply\",\"ok\":1,\"index\":"
          << n->last_log_index() << "}";
    }
  } else {
    out << "{\"type\":\"error\",\"msg\":\"unknown rpc\"}";
  }
  return out.str();
}

// --- server / tick / apply loops ----------------------------------------
static void accept_loop(RaftNode* n) {
  while (n->running.load()) {
    sockaddr_in peer{};
    socklen_t plen = sizeof(peer);
    int cfd = ::accept(n->listen_fd, (sockaddr*)&peer, &plen);
    if (cfd < 0) continue;
    std::thread([n, cfd]() {
      std::string req;
      while (n->running.load() && recv_msg(cfd, req)) {
        std::string resp = handle_rpc(n, req);
        if (!send_msg(cfd, resp)) break;
      }
      ::close(cfd);
    }).detach();
  }
}

static void start_election(RaftNode* n) {
  std::vector<Peer> peers;
  long long term, lli, llt;
  {
    std::lock_guard<std::mutex> lk(n->mu);
    n->role = Role::Candidate;
    n->current_term++;
    n->voted_for = n->id;
    n->reset_election_timeout();
    peers = n->peers;
    term = n->current_term;
    lli = n->last_log_index();
    llt = n->last_log_term();
  }
  std::atomic<int> votes{1};
  int majority = (int)(peers.size() + 1) / 2 + 1;
  std::vector<std::thread> threads;
  for (auto& pr : peers) {
    threads.emplace_back([n, pr, term, lli, llt, &votes]() {
      std::ostringstream req;
      req << "{\"type\":\"request_vote\",\"term\":" << term
          << ",\"candidate\":\"" << mj::esc(n->id) << "\""
          << ",\"last_log_index\":" << lli
          << ",\"last_log_term\":" << llt << "}";
      std::string resp = rpc_round_trip(pr.addr, req.str());
      if (resp.empty()) return;
      mj::Parser p(resp);
      auto m = p.parse();
      std::lock_guard<std::mutex> lk(n->mu);
      if (m.num["term"] > n->current_term) {
        become_follower(n, m.num["term"]);
        return;
      }
      if (m.num["granted"] && n->role == Role::Candidate &&
          n->current_term == term)
        votes++;
    });
  }
  for (auto& t : threads) t.join();
  std::lock_guard<std::mutex> lk(n->mu);
  if (n->role == Role::Candidate && n->current_term == term &&
      votes.load() >= majority) {
    n->role = Role::Leader;
    n->leader_id = n->id;
    for (auto& pr : n->peers) {
      pr.next_index = n->last_log_index() + 1;
      pr.match_index = 0;
    }
  }
}

static void replicate_to(RaftNode* n, Peer snapshot_peer) {
  long long term, prev_idx, prev_term, commit;
  std::vector<LogEntry> entries;
  bool need_snapshot = false;
  long long snap_idx = 0, snap_term = 0;
  std::string snap_data;
  {
    std::lock_guard<std::mutex> lk(n->mu);
    if (n->role != Role::Leader) return;
    term = n->current_term;
    if (snapshot_peer.next_index <= n->snapshot_index) {
      // the entries this follower needs were compacted away — ship the
      // snapshot blob instead and resume from its tail
      need_snapshot = true;
      snap_idx = n->snapshot_index;
      snap_term = n->snapshot_term;
      snap_data = n->snapshot_data;
    } else {
      prev_idx = snapshot_peer.next_index - 1;
      prev_term = prev_idx > 0 ? std::max(0LL, n->term_at(prev_idx)) : 0;
      for (long long i = snapshot_peer.next_index; i <= n->last_log_index();
           i++)
        entries.push_back(n->entry_at(i));
      commit = n->commit_index;
    }
  }
  if (need_snapshot) {
    std::ostringstream req;
    req << "{\"type\":\"install_snapshot\",\"term\":" << term
        << ",\"leader\":\"" << mj::esc(n->id) << "\""
        << ",\"snapshot_index\":" << snap_idx
        << ",\"snapshot_term\":" << snap_term
        << ",\"data\":\"" << b64enc(snap_data) << "\"}";
    std::string resp = rpc_round_trip(snapshot_peer.addr, req.str());
    if (resp.empty()) return;
    mj::Parser p(resp);
    auto m = p.parse();
    std::lock_guard<std::mutex> lk(n->mu);
    if (m.num["term"] > n->current_term) {
      become_follower(n, m.num["term"]);
      return;
    }
    if (m.num["ok"]) {
      for (auto& pr : n->peers) {
        if (pr.id != snapshot_peer.id) continue;
        pr.match_index = std::max(pr.match_index, snap_idx);
        pr.next_index = snap_idx + 1;
      }
    }
    return;
  }
  std::ostringstream req;
  req << "{\"type\":\"append_entries\",\"term\":" << term
      << ",\"leader\":\"" << mj::esc(n->id) << "\""
      << ",\"prev_log_index\":" << prev_idx
      << ",\"prev_log_term\":" << prev_term
      << ",\"leader_commit\":" << commit << ",\"entries\":[";
  for (size_t i = 0; i < entries.size(); i++) {
    if (i) req << ",";
    req << "{\"term\":\"" << entries[i].term << "\",\"data\":\""
        << b64enc(entries[i].data) << "\"}";
  }
  req << "]}";
  std::string resp = rpc_round_trip(snapshot_peer.addr, req.str());
  if (resp.empty()) return;
  mj::Parser p(resp);
  auto m = p.parse();
  std::lock_guard<std::mutex> lk(n->mu);
  if (m.num["term"] > n->current_term) { become_follower(n, m.num["term"]); return; }
  for (auto& pr : n->peers) {
    if (pr.id != snapshot_peer.id) continue;
    if (m.num["success"]) {
      pr.match_index = m.num["match_index"];
      pr.next_index = pr.match_index + 1;
    } else {
      // back off; the reply's match_index is the follower's last index,
      // so jump straight past any gap (one round to install_snapshot
      // for a fresh follower instead of one step per entry)
      pr.next_index = std::max(
          1LL, std::min(pr.next_index - 1, m.num["match_index"] + 1));
    }
  }
  // advance commit index: majority match on an entry from the current term
  for (long long idx = n->last_log_index();
       idx > std::max(n->commit_index, n->snapshot_index); idx--) {
    if (n->term_at(idx) != n->current_term) break;
    int count = 1;
    for (auto& pr : n->peers)
      if (pr.match_index >= idx) count++;
    if (count >= (int)(n->peers.size() + 1) / 2 + 1) {
      n->commit_index = idx;
      n->apply_cv.notify_all();
      break;
    }
  }
}

static void tick_loop(RaftNode* n) {
  while (n->running.load()) {
    std::this_thread::sleep_for(milliseconds(50));
    Role role;
    bool timed_out;
    std::vector<Peer> peers;
    {
      std::lock_guard<std::mutex> lk(n->mu);
      role = n->role;
      timed_out = duration_cast<milliseconds>(
                      steady_clock::now() - n->last_heartbeat)
                      .count() > n->election_timeout_ms;
      peers = n->peers;
    }
    if (role == Role::Leader) {
      std::vector<std::thread> threads;
      for (auto& pr : peers)
        threads.emplace_back([n, pr]() { replicate_to(n, pr); });
      for (auto& t : threads) t.join();
    } else if (timed_out && !peers.empty()) {
      start_election(n);
    } else if (timed_out && peers.empty()) {
      // single-node cluster: self-elect
      std::lock_guard<std::mutex> lk(n->mu);
      n->current_term++;
      n->role = Role::Leader;
      n->leader_id = n->id;
    }
    // single-node commit advance
    {
      std::lock_guard<std::mutex> lk(n->mu);
      if (n->role == Role::Leader && n->peers.empty() &&
          n->commit_index < n->last_log_index()) {
        n->commit_index = n->last_log_index();
        n->apply_cv.notify_all();
      }
    }
  }
}

static void apply_loop(RaftNode* n) {
  std::unique_lock<std::mutex> lk(n->mu);
  while (n->running.load()) {
    n->apply_cv.wait_for(lk, milliseconds(100));
    if (n->pending_restore_index >= 0) {
      long long idx = n->pending_restore_index;
      std::string data = std::move(n->pending_restore_data);
      n->pending_restore_index = -1;
      lk.unlock();
      if (n->restore_cb)
        n->restore_cb(data.data(), (int)data.size(), idx, n->restore_user);
      lk.lock();
    }
    while (n->last_applied < n->commit_index) {
      long long idx = ++n->last_applied;
      LogEntry entry = n->entry_at(idx);
      lk.unlock();
      if (n->apply_cb)
        n->apply_cb(entry.data.data(), (int)entry.data.size(), idx, n->user);
      lk.lock();
    }
  }
}

// ----------------------------------------------------------------- C ABI
extern "C" {

RaftNode* raft_create(const char* node_id, const char* bind_addr,
                      apply_cb_t cb, void* user) {
  auto* n = new RaftNode();
  n->id = node_id;
  std::string addr = bind_addr;
  auto colon = addr.rfind(':');
  n->bind_host = addr.substr(0, colon);
  n->bind_port = atoi(addr.substr(colon + 1).c_str());
  n->apply_cb = cb;
  n->user = user;
  n->reset_election_timeout();
  return n;
}

int raft_start(RaftNode* n) {
  n->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(n->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)n->bind_port);
  sa.sin_addr.s_addr = INADDR_ANY;
  if (::bind(n->listen_fd, (sockaddr*)&sa, sizeof(sa)) != 0) return -1;
  // timeout so accept() wakes up for shutdown
  struct timeval tv{0, 200000};
  setsockopt(n->listen_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  if (::listen(n->listen_fd, 64) != 0) return -1;
  n->running = true;
  n->accept_thread = std::thread(accept_loop, n);
  n->tick_thread = std::thread(tick_loop, n);
  n->apply_thread = std::thread(apply_loop, n);
  return 0;
}

int raft_add_voter(RaftNode* n, const char* id, const char* addr) {
  {
    std::lock_guard<std::mutex> lk(n->mu);
    bool exists = false;
    for (auto& pr : n->peers)
      if (pr.id == id) { pr.addr = addr; exists = true; }
    if (!exists && n->id != id) {
      Peer pr;
      pr.id = id;
      pr.addr = addr;
      pr.next_index = n->last_log_index() + 1;
      n->peers.push_back(pr);
    }
  }
  return 0;
}

// submit a log entry; returns assigned index, 0 if not leader
long long raft_submit(RaftNode* n, const char* data, int len) {
  std::lock_guard<std::mutex> lk(n->mu);
  if (n->role != Role::Leader) return 0;
  n->log.push_back({n->current_term, std::string(data, (size_t)len)});
  return n->last_log_index();
}

// Compact the log: record the executor-state blob for (index, term) =
// (last_applied, term_at(last_applied)) and drop entries at or below it.
// Returns the new snapshot_index (unchanged if nothing new to compact).
long long raft_snapshot(RaftNode* n, const char* data, int len) {
  std::lock_guard<std::mutex> lk(n->mu);
  if (n->last_applied <= n->snapshot_index) return n->snapshot_index;
  long long sidx = n->last_applied;
  n->snapshot_term = n->term_at(sidx);
  n->log.erase(n->log.begin(),
               n->log.begin() + (size_t)(sidx - n->snapshot_index));
  n->snapshot_index = sidx;
  n->snapshot_data = std::string(data, (size_t)len);
  return sidx;
}

// restore_cb(data, len, snapshot_index, user) fires when an installed
// snapshot replaces this node's state (fresh/lagging follower catch-up)
int raft_set_restore_cb(RaftNode* n, apply_cb_t cb, void* user) {
  std::lock_guard<std::mutex> lk(n->mu);
  n->restore_cb = cb;
  n->restore_user = user;
  return 0;
}

long long raft_log_length(RaftNode* n) {
  std::lock_guard<std::mutex> lk(n->mu);
  return (long long)n->log.size();
}

long long raft_snapshot_index(RaftNode* n) {
  std::lock_guard<std::mutex> lk(n->mu);
  return n->snapshot_index;
}

// 0=follower, 1=candidate, 2=leader
int raft_state(RaftNode* n) {
  std::lock_guard<std::mutex> lk(n->mu);
  return (int)n->role;
}

long long raft_commit_index(RaftNode* n) {
  std::lock_guard<std::mutex> lk(n->mu);
  return n->commit_index;
}

long long raft_term(RaftNode* n) {
  std::lock_guard<std::mutex> lk(n->mu);
  return n->current_term;
}

// leader id into buf; returns length
int raft_leader(RaftNode* n, char* buf, int buflen) {
  std::lock_guard<std::mutex> lk(n->mu);
  int len = (int)std::min((size_t)buflen - 1, n->leader_id.size());
  memcpy(buf, n->leader_id.data(), (size_t)len);
  buf[len] = 0;
  return len;
}

// JSON configuration into buf; returns length
int raft_get_configuration(RaftNode* n, char* buf, int buflen) {
  std::ostringstream out;
  {
    std::lock_guard<std::mutex> lk(n->mu);
    out << "{\"servers\":[{\"id\":\"" << mj::esc(n->id) << "\",\"addr\":\""
        << n->bind_host << ":" << n->bind_port << "\",\"self\":1}";
    for (auto& pr : n->peers)
      out << ",{\"id\":\"" << mj::esc(pr.id) << "\",\"addr\":\""
          << mj::esc(pr.addr) << "\",\"self\":0}";
    out << "],\"leader\":\"" << mj::esc(n->leader_id) << "\",\"term\":"
        << n->current_term << "}";
  }
  std::string s = out.str();
  int len = (int)std::min((size_t)buflen - 1, s.size());
  memcpy(buf, s.data(), (size_t)len);
  buf[len] = 0;
  return len;
}

void raft_shutdown(RaftNode* n) {
  n->running = false;
  n->apply_cv.notify_all();
  if (n->tick_thread.joinable()) n->tick_thread.join();
  if (n->apply_thread.joinable()) n->apply_thread.join();
  if (n->listen_fd >= 0) { ::shutdown(n->listen_fd, SHUT_RDWR); ::close(n->listen_fd); }
  if (n->accept_thread.joinable()) n->accept_thread.join();
  delete n;
}

}  // extern "C"
