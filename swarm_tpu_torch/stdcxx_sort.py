"""Pure-Python mirror of libstdc++ (GCC 12) std::sort.

The reference's d>=2 seeds comparator tests `strcmp(...) == -1`
(src/algo.cc:165-179), which is not a strict weak order: equal-mass
seeds whose headers differ by anything but an exact -1 first-byte
difference compare "equal" in both directions, and their relative
order in the output is whatever the sort algorithm happens to leave.
Byte parity therefore requires the exact introsort of GCC's
bits/stl_algo.h + bits/stl_heap.h, not merely the comparator.

This module is the fallback / differential-test oracle for the C
implementation in _native/swarm_native.c (sort_seeds_stdcxx).

`lt(a, b)` is the std::sort comparator (returns truthy when a orders
strictly before b). The list is sorted in place.
"""

_THRESHOLD = 16  # stl_algo.h _S_threshold


def stdcxx_sort(a: list, lt) -> None:
    """std::sort(a.begin(), a.end(), lt) as GCC 12 compiles it."""
    n = len(a)
    if n < 2:
        return
    # std::__lg(n) * 2
    depth = 2 * (n.bit_length() - 1)
    _introsort_loop(a, 0, n, depth, lt)
    _final_insertion_sort(a, 0, n, lt)


def _introsort_loop(a, first, last, depth, lt):
    while last - first > _THRESHOLD:
        if depth == 0:
            _heapsort(a, first, last, lt)
            return
        depth -= 1
        cut = _partition_pivot(a, first, last, lt)
        _introsort_loop(a, cut, last, depth, lt)
        last = cut


def _partition_pivot(a, first, last, lt):
    # __unguarded_partition_pivot: median of (first+1, mid, last-1)
    # moved to first, then unguarded partition of [first+1, last)
    mid = first + (last - first) // 2
    _move_median_to_first(a, first, first + 1, mid, last - 1, lt)
    pivot = a[first]
    lo, hi = first + 1, last
    while True:
        while lt(a[lo], pivot):
            lo += 1
        hi -= 1
        while lt(pivot, a[hi]):
            hi -= 1
        if not lo < hi:
            return lo
        a[lo], a[hi] = a[hi], a[lo]
        lo += 1


def _move_median_to_first(a, result, x, y, z, lt):
    if lt(a[x], a[y]):
        if lt(a[y], a[z]):
            a[result], a[y] = a[y], a[result]
        elif lt(a[x], a[z]):
            a[result], a[z] = a[z], a[result]
        else:
            a[result], a[x] = a[x], a[result]
    elif lt(a[x], a[z]):
        a[result], a[x] = a[x], a[result]
    elif lt(a[y], a[z]):
        a[result], a[z] = a[z], a[result]
    else:
        a[result], a[y] = a[y], a[result]


def _final_insertion_sort(a, first, last, lt):
    if last - first > _THRESHOLD:
        _insertion_sort(a, first, first + _THRESHOLD, lt)
        for i in range(first + _THRESHOLD, last):
            _unguarded_linear_insert(a, i, lt)
    else:
        _insertion_sort(a, first, last, lt)


def _insertion_sort(a, first, last, lt):
    for i in range(first + 1, last):
        if lt(a[i], a[first]):
            val = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = val
        else:
            _unguarded_linear_insert(a, i, lt)


def _unguarded_linear_insert(a, i, lt):
    val = a[i]
    j = i - 1
    while lt(val, a[j]):
        a[j + 1] = a[j]
        j -= 1
    a[j + 1] = val


def _heapsort(a, first, last, lt):
    # __partial_sort(first, last, last): __heap_select's scan loop is
    # empty when middle == last, so this is make_heap + sort_heap
    _make_heap(a, first, last, lt)
    while last - first > 1:
        last -= 1
        _pop_heap(a, first, last, last, lt)


def _make_heap(a, first, last, lt):
    if last - first < 2:
        return
    length = last - first
    parent = (length - 2) // 2
    while True:
        _adjust_heap(a, first, parent, length, a[first + parent], lt)
        if parent == 0:
            return
        parent -= 1


def _pop_heap(a, first, last, result, lt):
    value = a[result]
    a[result] = a[first]
    _adjust_heap(a, first, 0, last - first, value, lt)


def _adjust_heap(a, first, hole, length, value, lt):
    # sift the hole down to a leaf, then push the value back up
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if lt(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, first, hole, top, value, lt)


def _push_heap(a, first, hole, top, value, lt):
    parent = (hole - 1) // 2
    while hole > top and lt(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value
