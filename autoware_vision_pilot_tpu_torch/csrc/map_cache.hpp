// The weights' TMA tensor maps of the int8 kernels, kept for the process
// (sm90.cuh::weight_map). A map holds the tensor's address, its extents and
// the box alone, so the map of one key is the same map whatever the bytes
// behind the address hold: it is encoded at the first launch with that key
// and reused by every later one, whoever launches it (an eager wrapper, an
// exported program, the C++ loop). A copy of a weight lies at another
// address and gets a map of its own; another box (another N tile) is
// another map. Plain C++ (no CUDA), so that tests/test_torch_int8_plan.py
// builds it with g++ on any host.
#pragma once

#include <array>
#include <cstddef>
#include <map>
#include <mutex>

namespace avp {

template <typename Map>
class MapCache {
 public:
  // (kind, address, four extents, box)
  using Key = std::array<long long, 7>;

  // The map of `key` into *out: the kept one, else encode(&map) (0 on
  // success), kept if it succeeds. Returns 0 or encode's error.
  template <typename Encode>
  int get(Map* out, const Key& key, Encode encode) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      const auto it = maps_.find(key);
      if (it != maps_.end()) {
        *out = it->second;
        return 0;
      }
    }
    Map map;
    const int err = encode(&map);
    if (err) return err;
    std::lock_guard<std::mutex> lock(mu_);
    if (maps_.size() >= kMaxMaps) maps_.clear();  // weights freed long ago
    maps_.emplace(key, map);
    ++encodes_;
    *out = map;
    return 0;
  }

  // The maps encoded in this process so far.
  long long encodes() {
    std::lock_guard<std::mutex> lock(mu_);
    return encodes_;
  }

 private:
  static constexpr std::size_t kMaxMaps = 4096;
  std::mutex mu_;
  std::map<Key, Map> maps_;
  long long encodes_ = 0;
};

}  // namespace avp
