// ovsdb_lite: transactional key-value config/state store (C, shared lib).
//
// The native analog of the reference's ovsdb-server dependency
// (pkg/ovs/ovsconfig — bridge/port config + external-IDs
// persisted in OVSDB, the store the agent's cookie round and interface
// store survive restarts through; SURVEY §2.5 maps it to "in-process
// config store with on-disk snapshot ... same transactional semantics").
//
// Design: an append-only journal of committed transactions.  Each
// transaction is staged in memory (set/delete ops), then commit() writes
// one length-prefixed, checksummed record and fsyncs — torn trailing
// records are detected by checksum and ignored on replay, so a crash
// mid-commit atomically loses ONLY the uncommitted transaction (OVSDB's
// log-based durability model).  compact() rewrites the journal as one
// snapshot transaction.  Single-writer; readers go through the in-memory
// table.  The Python side (antrea_tpu/native/store.py) drives this over
// ctypes; keys and values are opaque byte strings.
//
// Record format (little-endian):
//   u32 magic 0x0A17DB01 | u32 body_len | u32 crc32(body) | body
//   body: u32 nops, then per op: u8 kind (0 set, 1 del),
//         u32 klen, key bytes, [u32 vlen, value bytes if set]

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x0A17DB01;

uint32_t crc32(const uint8_t* data, size_t n) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Op {
  uint8_t kind;  // 0 set, 1 del
  std::string key;
  std::string value;
};

struct Store {
  std::map<std::string, std::string> table;
  std::vector<Op> staged;
  std::string path;
  FILE* journal = nullptr;
  std::string last_error;
};

void put_u32(std::string& out, uint32_t v) {
  out.append(reinterpret_cast<const char*>(&v), 4);
}

bool read_u32(const uint8_t* p, size_t n, size_t& off, uint32_t* v) {
  if (off + 4 > n) return false;
  memcpy(v, p + off, 4);
  off += 4;
  return true;
}

std::string encode_body(const std::vector<Op>& ops) {
  std::string body;
  put_u32(body, static_cast<uint32_t>(ops.size()));
  for (const auto& op : ops) {
    body.push_back(static_cast<char>(op.kind));
    put_u32(body, static_cast<uint32_t>(op.key.size()));
    body.append(op.key);
    if (op.kind == 0) {
      put_u32(body, static_cast<uint32_t>(op.value.size()));
      body.append(op.value);
    }
  }
  return body;
}

bool apply_body(Store* s, const uint8_t* body, size_t n) {
  size_t off = 0;
  uint32_t nops;
  if (!read_u32(body, n, off, &nops)) return false;
  std::vector<Op> ops;
  ops.reserve(nops);
  for (uint32_t i = 0; i < nops; i++) {
    if (off + 1 > n) return false;
    Op op;
    op.kind = body[off++];
    uint32_t klen;
    if (!read_u32(body, n, off, &klen) || off + klen > n) return false;
    op.key.assign(reinterpret_cast<const char*>(body + off), klen);
    off += klen;
    if (op.kind == 0) {
      uint32_t vlen;
      if (!read_u32(body, n, off, &vlen) || off + vlen > n) return false;
      op.value.assign(reinterpret_cast<const char*>(body + off), vlen);
      off += vlen;
    } else if (op.kind != 1) {
      return false;
    }
    ops.push_back(std::move(op));
  }
  if (off != n) return false;
  for (const auto& op : ops) {
    if (op.kind == 0) {
      s->table[op.key] = op.value;
    } else {
      s->table.erase(op.key);
    }
  }
  return true;
}

bool write_record(Store* s, const std::string& body) {
  std::string rec;
  put_u32(rec, kMagic);
  put_u32(rec, static_cast<uint32_t>(body.size()));
  put_u32(rec, crc32(reinterpret_cast<const uint8_t*>(body.data()), body.size()));
  rec.append(body);
  if (fwrite(rec.data(), 1, rec.size(), s->journal) != rec.size()) return false;
  if (fflush(s->journal) != 0) return false;
  return true;
}

bool replay(Store* s, FILE* f) {
  // Read whole file; apply records until a torn/corrupt tail.
  if (fseek(f, 0, SEEK_END) != 0) return false;
  long len = ftell(f);
  if (len < 0) return false;
  if (fseek(f, 0, SEEK_SET) != 0) return false;
  std::vector<uint8_t> buf(static_cast<size_t>(len));
  if (len > 0 && fread(buf.data(), 1, buf.size(), f) != buf.size()) return false;
  size_t off = 0;
  while (off + 12 <= buf.size()) {
    uint32_t magic, blen, crc;
    memcpy(&magic, buf.data() + off, 4);
    memcpy(&blen, buf.data() + off + 4, 4);
    memcpy(&crc, buf.data() + off + 8, 4);
    if (magic != kMagic || off + 12 + blen > buf.size()) break;  // torn tail
    const uint8_t* body = buf.data() + off + 12;
    if (crc32(body, blen) != crc) break;  // corrupt tail record: stop
    if (!apply_body(s, body, blen)) break;
    off += 12 + blen;
  }
  return true;
}

}  // namespace

extern "C" {

Store* ovsdb_open(const char* path) {
  Store* s = new Store();
  s->path = path;
  FILE* f = fopen(path, "rb");
  if (f != nullptr) {
    bool ok = replay(s, f);
    fclose(f);
    if (!ok) {
      delete s;
      return nullptr;
    }
  }
  s->journal = fopen(path, "ab");
  if (s->journal == nullptr) {
    delete s;
    return nullptr;
  }
  return s;
}

void ovsdb_close(Store* s) {
  if (s == nullptr) return;
  if (s->journal) fclose(s->journal);
  delete s;
}

// Staged (transactional) mutations.
void ovsdb_txn_set(Store* s, const char* key, const uint8_t* val, uint32_t vlen) {
  Op op;
  op.kind = 0;
  op.key = key;
  op.value.assign(reinterpret_cast<const char*>(val), vlen);
  s->staged.push_back(std::move(op));
}

void ovsdb_txn_delete(Store* s, const char* key) {
  Op op;
  op.kind = 1;
  op.key = key;
  s->staged.push_back(std::move(op));
}

void ovsdb_txn_abort(Store* s) { s->staged.clear(); }

// Commit the staged transaction: one durable journal record, then apply
// to the in-memory table.  Returns 1 on success, 0 on failure (staged ops
// preserved so the caller may retry or abort).
int ovsdb_commit(Store* s) {
  if (s->staged.empty()) return 1;
  std::string body = encode_body(s->staged);
  if (!write_record(s, body)) {
    s->last_error = "journal write failed";
    return 0;
  }
  for (const auto& op : s->staged) {
    if (op.kind == 0) {
      s->table[op.key] = op.value;
    } else {
      s->table.erase(op.key);
    }
  }
  s->staged.clear();
  return 1;
}

// Read: returns value length, copies min(len, cap) bytes into out.
// Returns -1 if the key is absent.
int64_t ovsdb_get(Store* s, const char* key, uint8_t* out, uint32_t cap) {
  auto it = s->table.find(key);
  if (it == s->table.end()) return -1;
  uint32_t n = static_cast<uint32_t>(it->second.size());
  uint32_t c = n < cap ? n : cap;
  if (c > 0) memcpy(out, it->second.data(), c);
  return n;
}

uint64_t ovsdb_count(Store* s) { return s->table.size(); }

// Key iteration: index-based (stable between mutations only).
int64_t ovsdb_key_at(Store* s, uint64_t idx, uint8_t* out, uint32_t cap) {
  if (idx >= s->table.size()) return -1;
  auto it = s->table.begin();
  std::advance(it, static_cast<long>(idx));
  uint32_t n = static_cast<uint32_t>(it->first.size());
  uint32_t c = n < cap ? n : cap;
  if (c > 0) memcpy(out, it->first.data(), c);
  return n;
}

// Rewrite the journal as one snapshot transaction (log compaction).
int ovsdb_compact(Store* s) {
  std::string tmp = s->path + ".compact";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (f == nullptr) return 0;
  std::vector<Op> ops;
  ops.reserve(s->table.size());
  for (const auto& kv : s->table) {
    Op op;
    op.kind = 0;
    op.key = kv.first;
    op.value = kv.second;
    ops.push_back(std::move(op));
  }
  std::string body = encode_body(ops);
  std::string rec;
  put_u32(rec, kMagic);
  put_u32(rec, static_cast<uint32_t>(body.size()));
  put_u32(rec, crc32(reinterpret_cast<const uint8_t*>(body.data()), body.size()));
  rec.append(body);
  bool ok = fwrite(rec.data(), 1, rec.size(), f) == rec.size() && fflush(f) == 0;
  fclose(f);
  if (!ok) {
    remove(tmp.c_str());
    return 0;
  }
  fclose(s->journal);
  s->journal = nullptr;
  if (rename(tmp.c_str(), s->path.c_str()) != 0) {
    s->journal = fopen(s->path.c_str(), "ab");
    return 0;
  }
  s->journal = fopen(s->path.c_str(), "ab");
  return s->journal != nullptr ? 1 : 0;
}

}  // extern "C"
