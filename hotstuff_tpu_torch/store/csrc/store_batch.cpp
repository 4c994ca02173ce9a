// Batched appends for the WAL engine of native/store_engine.cpp.
//
// The engine writes each put with one write(2), and a committed block
// applies one ledger put a payload (store/state.py): up to 512 puts, so
// 512 system calls, for each node of the committee.  hs_put_many takes
// the records of many puts and deletes, already in the WAL's record
// format (u32 klen | u32 vlen | key | value, vlen 0xFFFFFFFF a delete
// with no value bytes), checks them, appends them with one write and
// then applies them to the index in order, exactly as hs_put and
// hs_delete apply one record each.  The log bytes are those of the same
// puts made one by one.  A malformed blob is refused before anything is
// written.  With fsync_mode 1 the batch is synced once, after its write.
//
// The engine itself is compiled here, unchanged, so that the batch can
// reach its state: this file is the library's one translation unit, and
// the build puts native/ on the include path.

#include "store_engine.cpp"  // native/, on the include path

namespace {

// Walk the records of blob[0, n): call fn(key, klen, value, vlen,
// tombstone) for each.  False if a record runs past the end.
template <typename Fn>
bool walk_records(const uint8_t* blob, uint64_t n, Fn fn) {
  uint64_t off = 0;
  while (off < n) {
    if (off + 8 > n) return false;
    uint32_t klen, vfield;
    std::memcpy(&klen, blob + off, 4);
    std::memcpy(&vfield, blob + off + 4, 4);
    off += 8;
    bool tombstone = vfield == kTombstone;
    uint64_t vlen = tombstone ? 0 : vfield;
    if (off + klen + vlen > n) return false;
    fn(blob + off, klen, blob + off + klen, static_cast<uint32_t>(vlen), tombstone);
    off += klen + vlen;
  }
  return true;
}

}  // namespace

extern "C" {

int hs_put_many(void* h, const uint8_t* blob, uint64_t n) {
  auto* e = static_cast<Engine*>(h);
  auto nothing = [](const uint8_t*, uint32_t, const uint8_t*, uint32_t, bool) {};
  if (!walk_records(blob, n, nothing)) return -1;
  if (!write_all(e->fd, blob, n)) return -1;
  e->wal_bytes += n;
  if (e->fsync_mode == 1 && ::fdatasync(e->fd) != 0) return -1;
  walk_records(blob, n, [e](const uint8_t* k, uint32_t klen, const uint8_t* v,
                            uint32_t vlen, bool tombstone) {
    std::string key(reinterpret_cast<const char*>(k), klen);
    auto it = e->index.find(key);
    if (it != e->index.end()) {
      e->live_bytes -= record_size(it->first.size(), it->second.size());
      if (tombstone) e->index.erase(it);
    }
    if (!tombstone) {
      e->live_bytes += record_size(klen, vlen);
      e->index[std::move(key)].assign(reinterpret_cast<const char*>(v), vlen);
    }
  });
  return 0;
}

}  // extern "C"
